"""The processes of `tests/test_torch_distributed.py`: one rank each of a
gloo group of 4 CPU processes, all scenarios in one spawn.

Besides the steps of the distribution layer: the `Trainer` on the (2, 2)
mesh with its checkpoints, their elastic restore onto (4, 1) and (1, 4),
a checkpoint the JAX manager wrote (by the parent, in ``jax_ckpt``)
restored onto (2, 2) and saved again, and the CoMeFa grid sharded over
the 4 ranks.

Each rank runs every scenario (collectives need all of them); rank 0
writes the numbers the tests hold to ``results.json`` in the output
directory, and every rank writes its `compress_psum` output.  Imports
torch and the port only (no JAX), so the children start quickly.
"""
import copy
import json
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

WORLD = 4
MESH = (2, 2)                  # ("data", "model")
FAMILIES = ("xlstm-1.3b", "recurrentgemma-2b", "mixtral-8x7b")


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _on_model(tensors, mesh_dim=1):
    """Names of the tensors sharded along the "model" mesh dim."""
    return sorted(n for n, t in tensors.items() if isinstance(t, DTensor)
                  and isinstance(t.placements[mesh_dim], Shard))


# 3 heads and 3 KV heads of 16 on a 2-wide model axis: the projections'
# 48 columns split 24 a rank, 1.5 heads, so the head split reshards
# (`sharding.reshape`) and attention runs with its heads gathered
UNEVEN = dict(n_heads=3, kv_heads=3)


def _decode(engine, lm, cm, configs, mesh, name, quant, **over):
    base = configs.get(name)
    cfg = cm.reduced(base, vocab=128, n_layers=max(2, len(base.pattern)),
                     dtype="float32", quant_bits=quant, **over)
    model = lm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    tok = torch.tensor([[3], [5], [7], [9]])
    ref_states = lm.decode_state_init(cfg, 4, 16, "cpu")
    refs = []
    for t in range(3):
        logits, ref_states = lm.decode_step(model, tok + t, ref_states, t)
        refs.append(logits)
    fn = engine.make_jitted_serve_step(mesh, cfg)
    states = lm.decode_state_init(cfg, 4, 16, "cpu")
    gaps, worst = [], 0.0
    for t in range(3):
        logits, states = fn(model, tok + t, states, t)
        gaps.append(float((logits - refs[t]).abs().max()))
        worst = max(worst, float(((logits - refs[t]).abs()
                                  / (2e-3 + 2e-3 * refs[t].abs())).max()))
    state_ratio = max(float(((_full(v) - ref_states[j][k]).abs()
                             / (2e-3 + 2e-3 * ref_states[j][k].abs())).max())
                      for j, st in enumerate(states) for k, v in st.items())
    state_names = {f"{j}.{k}": v for j, st in enumerate(states)
                   for k, v in st.items()}
    return {"gaps": gaps, "ratio": worst, "state_ratio": state_ratio,
            "params_on_model": _on_model(model.state_dict()),
            "states_on_model": _on_model(state_names),
            "packed": sum(k.endswith(".packed") for k in model.state_dict())}


def _train(st, opt, lm, cm, configs, pipe, mesh, int8=False,
           microbatches=1, **over):
    cfg = cm.reduced(configs.get("smollm-360m"), vocab=128, n_layers=2,
                     dtype="float32", **over)
    tcfg = st.TrainConfig(adamw=opt.AdamWConfig(
        lr=1e-3, warmup_steps=0, int8_second_moment=int8),
        microbatches=microbatches)
    data = pipe.SyntheticLM(pipe.DataConfig(vocab=128, global_batch=8,
                                            seq_len=32))
    batch = data.batch_at(0)
    state = st.init_state(torch.Generator().manual_seed(0), cfg, tcfg,
                          "cpu")
    ref = copy.deepcopy(state)
    ref, ref_metrics = st.train_step(ref, batch, cfg, tcfg)
    fn = st.make_jitted_train_step(mesh, cfg, tcfg)
    state, metrics = fn(state, batch)
    out = {"loss": float(_full(metrics["loss"])),
           "ref_loss": float(ref_metrics["loss"]),
           "grad_norm": float(_full(metrics["grad_norm"])),
           "ref_grad_norm": float(ref_metrics["grad_norm"]),
           "step": int(_full(state["step"]))}
    ratio = 0.0
    ref_sd = ref["params"].state_dict()
    sd = state["params"].state_dict()
    for n, a in ref_sd.items():
        b = _full(sd[n])
        ratio = max(ratio, float(((a - b).abs()
                                  / (2e-4 + 2e-3 * a.abs())).max()))
    out["param_ratio"] = ratio
    # m and an f32 v relative to the leaf's largest; the int8 v's levels
    # and its blocks' log2 offsets absolute
    for k in next(iter(state["opt"].values())):
        out[f"{k}_gap"] = max(
            float((_full(s[k]).float() - ref["opt"][n][k].float()).abs().max()
                  / (1.0 if k in ("v_q", "v_s") else
                     ref["opt"][n][k].float().abs().max().clamp(min=1e-30)))
            for n, s in state["opt"].items())
    out["params_on_model"] = _on_model(sd)
    out["moments_on_model"] = _on_model(
        {f"{n}.{k}": t for n, s in state["opt"].items()
         for k, t in s.items()})
    out["int8"] = int8
    return out


def _loop_setup(st, opt, cm, configs, pipe, ckpt_dir, total_steps=3):
    from repro_torch.train import loop as loop_mod
    cfg = cm.reduced(configs.get("smollm-360m"), vocab=128, n_layers=2,
                     dtype="float32")
    # JAX's own sharded-step settings (tests/test_distributed.py): Adam
    # turns an f32 reordering of a near-cancelled gradient element into a
    # share of one update, so the params hold scales with the rate (at
    # lr 3e-3 one element of stack.0.ffn.wo.w lands at 1.44x the hold)
    tcfg = st.TrainConfig(adamw=opt.AdamWConfig(lr=1e-3, warmup_steps=0,
                                                total_steps=total_steps))
    lcfg = loop_mod.LoopConfig(total_steps=total_steps, ckpt_every=2,
                               ckpt_dir=ckpt_dir, log_every=100)
    data = pipe.SyntheticLM(pipe.DataConfig(vocab=128, global_batch=8,
                                            seq_len=32, seed=5))
    return loop_mod, cfg, tcfg, lcfg, data


def _trainer_on_mesh(st, opt, cm, configs, pipe, mesh, out_dir):
    """`Trainer(mesh=(2, 2))` for 3 steps, checkpointing every 2, against
    the one-process step on the same batches."""
    loop_mod, cfg, tcfg, lcfg, data = _loop_setup(
        st, opt, cm, configs, pipe, os.path.join(out_dir, "mesh_ckpt"))
    trainer = loop_mod.Trainer(cfg, tcfg, lcfg, data, mesh=mesh,
                               device="cpu")
    state = trainer.init_or_restore()
    ref = copy.deepcopy(state)
    losses = []
    state = trainer.run(state, on_step=lambda i, s, m: losses.append(
        loop_mod.host_float(m["loss"])))
    ref_losses = []
    for i in range(lcfg.total_steps):
        ref, m = st.train_step(ref, data.batch_at(i), cfg, tcfg)
        ref_losses.append(float(m["loss"]))
    ratio, worst = 0.0, ""
    sd = state["params"].state_dict()
    for n, a in ref["params"].state_dict().items():
        b = _full(sd[n])
        r = (a - b).abs() / (2e-4 + 2e-3 * a.abs())
        if float(r.max()) > ratio:
            i = int(r.argmax())
            ratio = float(r.max())
            worst = (f"{n}[{i}]: {float(a.flatten()[i])!r} vs "
                     f"{float(b.flatten()[i])!r}")
    return {"losses": losses, "ref_losses": ref_losses,
            "param_ratio": ratio, "worst": worst,
            "step": int(_full(state["step"])),
            "params_on_model": _on_model(sd),
            "steps_saved": trainer.ckpt.all_steps()}


def _file_leaves(ckpt_dir, step):
    """The arrays of a checkpoint directory, by position, as torch."""
    from repro_torch.checkpoint import manager as mgr_mod
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, mgr_mod.MANIFEST)) as f:
        entries = json.load(f)["leaves"]
    out = []
    for e in entries:
        with open(os.path.join(d, e["file"]), "rb") as f:
            out.append(mgr_mod._from_bytes(bytearray(f.read()), e["dtype"],
                                           e["shape"]))
    return out


def _elastic(st, opt, cm, configs, pipe, out_dir):
    """The (2, 2) run's checkpoint restored by a `Trainer` on (4, 1) and
    on (1, 4): every leaf bit for bit the file's, and some sharded."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import manager as mgr_mod
    ckpt = os.path.join(out_dir, "mesh_ckpt")
    want = _file_leaves(ckpt, 3)
    res = {}
    for shape in ((4, 1), (1, 4)):
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        loop_mod, cfg, tcfg, lcfg, data = _loop_setup(
            st, opt, cm, configs, pipe, ckpt)
        trainer = loop_mod.Trainer(cfg, tcfg, lcfg, data, mesh=mesh,
                                   device="cpu")
        state = trainer.init_or_restore()
        named = mgr_mod.leaves(state)
        equal = [torch.equal(_full(t), w) for (_, t), w in zip(named, want)]
        sharded = sorted(n for n, t in named if isinstance(t, DTensor)
                         and any(isinstance(p, Shard) for p in t.placements))
        # a second restore writes each shard in place
        trainer.init_or_restore()
        res["x".join(map(str, shape))] = {
            "leaves": len(named), "equal": sum(equal),
            "step": int(_full(state["step"])), "sharded": sharded}
    return res


def _jax_written(st, opt, cm, configs, pipe, mesh, out_dir):
    """The JAX manager's checkpoint (written by the parent) restored by
    a `Trainer` on (2, 2) and saved again from the placed state."""
    from repro_torch.checkpoint import CheckpointManager
    loop_mod, cfg, tcfg, lcfg, data = _loop_setup(
        st, opt, cm, configs, pipe, os.path.join(out_dir, "jax_ckpt"))
    trainer = loop_mod.Trainer(cfg, tcfg, lcfg, data, mesh=mesh,
                               device="cpu")
    state = trainer.init_or_restore()
    placed = isinstance(state["params"].embed["e"], DTensor)
    CheckpointManager(os.path.join(out_dir, "jax_back")).save(
        int(_full(state["step"])), state)
    return {"placed": placed}


def _grid(out_dir, rank):
    """`ComefaGrid` sharded over the 4 ranks against the unsharded grid
    (8 slots: 2 a rank; 3 slots: replicated), and the batched GEMV and
    GEMM with ``mesh=`` against the calls without it."""
    from repro_torch.core.comefa import grid as gmod
    from repro_torch.core.comefa import layout, program
    from repro_torch.core.comefa.isa import N_COLS
    from repro_torch.kernels import comefa_sim as cs
    mesh = gmod.grid_mesh(device="cpu")
    rng = np.random.default_rng(7)
    prog = program.mul(list(range(4)), list(range(4, 8)),
                       list(range(8, 16))).optimize()
    res = {}
    for g in (8, 3):
        plain = gmod.ComefaGrid(g, n_blocks=2, device="cpu")
        shard = gmod.ComefaGrid(g, n_blocks=2, mesh=mesh, device="cpu")
        vals = rng.integers(0, 16, size=(g, 2, N_COLS))
        for s in range(g):
            for grid in (plain, shard):
                layout.place(grid.slot(s), vals[s], 0, 4)
                layout.place(grid.slot(s), vals[s] ^ 5, 4, 4)
        cycles = [plain.run(prog), shard.run(prog)]
        progs = [program.zero_rows(range(20, 21 + s % 3)) for s in range(g)]
        per_slot = [plain.run_per_slot(progs), shard.run_per_slot(progs)]
        rows = [plain.read_rows(range(8, 16)), shard.read_rows(range(8, 16))]
        held = shard._local_slots()[1]
        res[f"g{g}"] = {
            "cycles": cycles, "per_slot": per_slot,
            "totals": [plain.cycles, shard.cycles],
            "dispatches": [plain.dispatches, shard.dispatches],
            "rows_equal": bool(torch.equal(*rows)),
            "state_equal": bool(all(np.array_equal(getattr(plain, k),
                                                   getattr(shard, k))
                                    for k in ("mem", "carry", "mask"))),
            "placements": str(shard._where[0]), "held": held}
        # the sharded grid rebuilt from its arrays runs on as the plain one
        back = gmod.ComefaGrid.from_arrays(shard.to_arrays(), mesh=mesh)
        back.run(prog)
        plain.run(prog)
        res[f"g{g}"]["rebuilt"] = bool(np.array_equal(back.mem, plain.mem)
                                       and back.cycles == plain.cycles)
    w = rng.integers(0, 16, (8, 40, 70))
    x = rng.integers(0, 16, (8, 40))
    gemv = {}
    for recode in (None, "booth", "auto"):
        got, stats = [], []
        for m in (None, mesh):
            stats.append({})
            got.append(cs.comefa_gemv_batched(
                w, x, w_bits=4, x_bits=4, recode=recode, stats=stats[-1],
                mesh=m, engine="packed", device="cpu"))
        gemv[str(recode)] = {"equal": bool(np.array_equal(*got)),
                             "stats": stats}
        if rank == 0:
            np.save(os.path.join(out_dir, f"gemv_{recode}.npy"), got[1])
    a = rng.integers(0, 8, (4, 3, 5))
    b = rng.integers(0, 8, (4, 5, 4))
    gemm = [cs.comefa_gemm_batched(a, b, bits=3, mesh=m, engine="packed",
                                   device="cpu") for m in (None, mesh)]
    res["gemv"] = gemv
    res["gemm_equal"] = bool(np.array_equal(*gemm))
    if rank == 0:
        np.save(os.path.join(out_dir, "gemm.npy"), gemm[1])
        np.savez(os.path.join(out_dir, "grid_inputs.npz"), w=w, x=x, a=a,
                 b=b)
    return res


def main(rank: int, store_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch import configs
        from repro_torch.data import pipeline as pipe
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.models import common as cm
        from repro_torch.models import lm
        from repro_torch.parallel import compression, pipeline as pp
        from repro_torch.serve import engine
        from repro_torch.train import optimizer as opt
        from repro_torch.train import step as st

        host = mesh_mod.make_host_mesh("cpu")
        res = {"host_mesh": [list(host.mesh_dim_names), list(host.shape)]}
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
        res["train"] = _train(st, opt, lm, cm, configs, pipe, mesh)
        res["train_int8"] = _train(st, opt, lm, cm, configs, pipe, mesh,
                                   int8=True)
        res["train_micro2"] = _train(st, opt, lm, cm, configs, pipe, mesh,
                                     microbatches=2)
        res["train_uneven"] = _train(st, opt, lm, cm, configs, pipe, mesh,
                                     **UNEVEN)
        res["decode_smollm_uneven"] = _decode(engine, lm, cm, configs, mesh,
                                              "smollm-360m", None, **UNEVEN)
        res["trainer"] = _trainer_on_mesh(st, opt, cm, configs, pipe, mesh,
                                          out_dir)
        res["elastic"] = _elastic(st, opt, cm, configs, pipe, out_dir)
        res["jax_written"] = _jax_written(st, opt, cm, configs, pipe, mesh,
                                          out_dir)
        res["grid"] = _grid(out_dir, rank)
        res["decode_gemma2"] = _decode(engine, lm, cm, configs, mesh,
                                       "gemma2-27b", None)
        res["decode_smollm_q8"] = _decode(engine, lm, cm, configs, mesh,
                                          "smollm-360m", 8)
        # the recurrent states (mLSTM, sLSTM, RG-LRU) and the MoE, placed
        for name in FAMILIES:
            res[f"decode_{name}_q8"] = _decode(engine, lm, cm, configs,
                                               mesh, name, 8)

        # GPipe over 4 stages, as tests/test_distributed.py does for JAX
        n_stages, n_micro, mb, d = WORLD, 8, 2, 16
        rng = np.random.default_rng(0)
        w = torch.as_tensor(rng.normal(size=(n_stages, d, d)) / np.sqrt(d),
                            dtype=torch.float32)
        x = torch.as_tensor(rng.normal(size=(n_micro, mb, d)),
                            dtype=torch.float32)
        y = pp.pipelined_apply(lambda wi, h: torch.tanh(h @ wi))(w, x)
        seq = x
        for s in range(n_stages):
            seq = torch.tanh(seq @ w[s])
        res["pipeline_gap"] = float((y - seq).abs().max())
        res["bubble"] = pp.bubble_fraction(n_stages, n_micro)

        # the int8 all-reduce: each rank's own leaf, saved for the parent
        g = np.random.default_rng(0).normal(size=(WORLD, 4096)).astype(
            np.float32)
        err = np.random.default_rng(1).normal(size=(WORLD, 4096)).astype(
            np.float32) * 1e-3
        avg, new_err = compression.compress_psum(torch.as_tensor(g[rank]),
                                                 torch.as_tensor(err[rank]))
        tree, _ = compression.compressed_grad_allreduce(
            {"w": torch.as_tensor(g[rank]).reshape(64, 64)},
            {"w": torch.as_tensor(err[rank]).reshape(64, 64)})
        np.save(os.path.join(out_dir, f"tree{rank}.npy"), tree["w"].numpy())
        np.save(os.path.join(out_dir, f"avg{rank}.npy"), avg.numpy())
        np.save(os.path.join(out_dir, f"err{rank}.npy"), new_err.numpy())
        if rank == 0:
            with open(os.path.join(out_dir, "results.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()
