"""The processes of `tests/test_torch_distributed.py`: one rank each of a
gloo group of 4 CPU processes, all scenarios in one spawn.

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


def _decode(engine, lm, cm, configs, mesh, name, quant):
    base = configs.get(name)
    cfg = cm.reduced(base, vocab=128, n_layers=max(2, len(base.pattern)),
                     dtype="float32", quant_bits=quant)
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
           microbatches=1):
    cfg = cm.reduced(configs.get("smollm-360m"), vocab=128, n_layers=2,
                     dtype="float32")
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
