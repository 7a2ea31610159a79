"""The port's distribution layer across processes, against one process
and against the JAX package.

One spawn of 4 gloo CPU processes (`tests/_dist_worker.py`) on a (2, 2)
``("data", "model")`` `DeviceMesh` runs every scenario, with reduced
configs (vocab 128, 2 layers, f32), as `tests/test_distributed.py` does
for JAX on 8 host devices:

- `train.step.make_jitted_train_step` (SmolLM, batch 8 x 32; also with
  the int8 second moment, and in 2 microbatches) against the
  one-process `train_step`: JAX's own hold, loss rtol 1e-4 and params
  rtol 2e-3 / atol 2e-4 after the step; since the learning rate at step
  0 is 0 (in both packages), also the moments the step writes: v (f32,
  the squared gradients) within 1e-4 of each leaf's largest, or the
  int8 v within one level, m within one bf16 ulp (2^-7 of the leaf's
  largest);
- `serve.engine.make_jitted_serve_step` on Gemma-2 and, with 8-bit
  planes (the bit-plane kernel's plain version on each rank's shards),
  on SmolLM, xLSTM (mLSTM and sLSTM states), RecurrentGemma (RG-LRU
  states) and Mixtral (the MoE), three steps, logits and states rtol and
  atol 2e-3;
- `parallel.pipeline.pipelined_apply` over 4 stages against the
  sequential stack, within 1e-5;
- `parallel.compression.compress_psum` over 4 ranks, exactly equal to
  JAX's, run here with ``jax.vmap(..., axis_name="pod")``;
- `train.loop.Trainer(mesh=)` on (2, 2) for 3 steps against the
  one-process step (the same hold), its checkpoint byte for byte what
  one process writes from the same values, restored by `Trainer`s on
  (4, 1) and (1, 4) (``restore(shardings=)``) and into this process, bit
  for bit; a checkpoint the JAX manager writes restores onto (2, 2);
- `ComefaGrid(mesh=grid_mesh())` (8 slots, 2 a rank; 3 slots,
  replicated) against the unsharded grid, and `comefa_gemv_batched` and
  `comefa_gemm_batched` with ``mesh=`` against the calls without it and
  JAX's, exactly, cycles included.

Each config must really shard a leaf on "model", so that the holds
prove something.  The gaps are printed.  NCCL takes one rank a card, so
the multi-rank forms run on gloo here; the card runs the one-rank forms
(`chip_smoke.py` phase 18).
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import _dist_worker
from repro.checkpoint import manager as jax_manager
from repro.parallel import compression as jcompression
from repro_torch.parallel import compression

SPAWN_TIMEOUT_S = 240
ROOT = Path(__file__).resolve().parents[1]


def _write_jax_checkpoint(out):
    """The port's (2, 2) trainer state, perturbed, written at step 7 by
    the JAX manager: leaves in the port's order under sorted keys (JAX
    flattens a dict by sorted key; restore matches by position)."""
    import jax.numpy as jnp
    import torch

    from repro_torch import configs
    from repro_torch.checkpoint import manager
    from repro_torch.data import pipeline as pipe
    from repro_torch.models import common as cm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st
    _, cfg, tcfg, _, _ = _dist_worker._loop_setup(st, opt, cm, configs,
                                                  pipe, "")
    state = st.init_state(torch.Generator().manual_seed(1), cfg, tcfg,
                          "cpu")
    rng = np.random.default_rng(3)
    tree = {}
    for i, (name, t) in enumerate(manager.leaves(state)):
        if name == "step":
            a = np.asarray(7, np.int32)
        elif t.dtype == torch.bfloat16:
            a = (t.float() + 0.5).to(torch.bfloat16).view(
                torch.int16).numpy().view(jnp.bfloat16)
        else:
            a = t.numpy() + rng.normal(size=t.shape).astype(t.numpy().dtype)
        tree[f"{i:05d}"] = a
    jax_manager.CheckpointManager(str(out / "jax_ckpt")).save(7, tree)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Spawn the 4 ranks once for the whole file; a hang fails the tests
    after `SPAWN_TIMEOUT_S` instead of stalling the suite."""
    out = tmp_path_factory.mktemp("dist")
    _write_jax_checkpoint(out)
    ctx = mp.start_processes(_dist_worker.main, nprocs=_dist_worker.WORLD,
                             args=(str(out / "store"), str(out)),
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo ranks did not finish in "
                            f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    res = json.loads((out / "results.json").read_text())
    res["dir"] = out
    return res


def test_host_mesh_takes_every_rank(results):
    assert results["host_mesh"] == [["data", "model"], [1, 4]]


@pytest.mark.parametrize("case", ["train", "train_int8", "train_micro2",
                                  "train_uneven"])
def test_sharded_train_step_matches_one_process(results, case):
    """f32 v, the int8 v (its levels within one, its blocks' log2
    offsets within 1e-3), and 2 microbatches."""
    r = results[case]
    gaps = {k[:-4]: v for k, v in r.items() if k.endswith("_gap")}
    print(f"{case}: loss {r['loss']!r} vs {r['ref_loss']!r}, grad norm "
          f"{r['grad_norm']!r} vs {r['ref_grad_norm']!r}, params "
          f"{r['param_ratio']:.3g} of the hold, moments {gaps}")
    assert r["step"] == 1
    np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=1e-4)
    np.testing.assert_allclose(r["grad_norm"], r["ref_grad_norm"],
                               rtol=1e-4)
    assert r["param_ratio"] <= 1.0
    assert gaps["m"] <= 2.0 ** -7
    if r["int8"]:
        assert gaps["v_q"] <= 1 and gaps["v_s"] <= 1e-3
        assert "stack.0.ffn.wi.w.v_q" in r["moments_on_model"]
    else:
        assert gaps["v"] <= 1e-4
        assert "stack.0.ffn.wi.w.v" in r["moments_on_model"]
    assert "stack.0.ffn.wi.w" in r["params_on_model"]


@pytest.mark.parametrize("case", ["decode_gemma2", "decode_smollm_q8",
                                  "decode_smollm_uneven"] + [
    f"decode_{name}_q8" for name in _dist_worker.FAMILIES])
def test_sharded_decode_matches_one_process(results, case):
    r = results[case]
    print(f"{case}: logits gaps {r['gaps']}, {r['ratio']:.3g} of the hold;"
          f" states {r['state_ratio']:.3g} of the hold; on model: "
          f"{len(r['params_on_model'])} params, "
          f"{len(r['states_on_model'])} state tensors")
    assert r["ratio"] <= 1.0
    assert r["state_ratio"] <= 1.0
    assert r["params_on_model"] and r["states_on_model"]
    if case == "decode_smollm_q8":
        assert r["packed"] == 14
        assert "stack.0.mix.wq.packed" in r["params_on_model"]
        assert "stack.0.mix.wo.packed" in r["params_on_model"]


def test_pipeline_matches_sequential(results):
    print(f"pipeline: gap {results['pipeline_gap']!r}, bubble "
          f"{results['bubble']:.3f}")
    assert results["pipeline_gap"] <= 1e-5
    assert results["bubble"] == 3 / 11


def test_compressed_allreduce_equals_jax(results):
    world = 4
    g = np.random.default_rng(0).normal(size=(world, 4096)).astype(
        np.float32)
    err = np.random.default_rng(1).normal(size=(world, 4096)).astype(
        np.float32) * 1e-3
    f = jax.vmap(lambda gg, ee: jcompression.compress_psum(gg, ee, "pod"),
                 axis_name="pod")
    want_avg, want_err = (np.asarray(a) for a in f(jnp.asarray(g),
                                                   jnp.asarray(err)))
    for r in range(world):
        avg = np.load(results["dir"] / f"avg{r}.npy")
        new_err = np.load(results["dir"] / f"err{r}.npy")
        np.testing.assert_array_equal(avg, want_avg[r])
        np.testing.assert_array_equal(new_err, want_err[r])
        # the tree form, on a leaf of its own shape, reduces alike
        tree = np.load(results["dir"] / f"tree{r}.npy")
        np.testing.assert_array_equal(tree, want_avg[r].reshape(64, 64))
    expect = g.mean(0)
    rel = np.linalg.norm(want_avg[0] - expect) / np.linalg.norm(expect)
    assert rel < 0.05


def test_wire_bytes_equal_jax():
    import torch
    shapes = {"a": (3, 1000), "b": (4096,), "c": (1,), "d": (1025, 7)}
    port = {k: torch.zeros(s) for k, s in shapes.items()}
    jtree = {k: jnp.zeros(s) for k, s in shapes.items()}
    for c in (False, True):
        assert compression.wire_bytes(port, c) == \
            jcompression.wire_bytes(jtree, c)
    err = compression.init_error_state(port)
    assert all(e.dtype == torch.float32 and e.shape == port[k].shape
               and not e.any() for k, e in err.items())



# -- one rank, in this process: the forms the card runs ---------------------

@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group and its (1, 1) host mesh, started by
    `make_host_mesh("cpu")` on a port the OS picks, and stopped after."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    if dist.is_initialized():
        pytest.skip("a process group is already running here")
    mesh = mesh_mod.make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def test_one_rank_host_mesh(one_rank):
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    assert tuple(one_rank.shape) == (1, 1)
    assert one_rank.mesh_dim_names == ("data", "model")
    assert dist.get_backend() == "gloo"
    with pytest.raises(RuntimeError, match="256 ranks"):
        mesh_mod.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        mesh_mod.make_production_mesh(multi_pod=True, device="cpu")


def test_host_mesh_without_cuda_raises():
    import torch
    from repro_torch.launch import mesh as mesh_mod
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        mesh_mod.make_host_mesh()                   # default device: cuda


def test_one_rank_serve_step_is_the_eager_step(one_rank):
    """On one CPU rank the compiled step places nothing: its logits and
    states are the eager step's, exactly, and the packed-linear hook
    (host-side, never seen by the compiled step) does not fire."""
    import torch
    from repro_torch import configs
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.serve import engine
    cfg = cm.reduced(configs.get("smollm-360m"), vocab=128, n_layers=2,
                     quant_bits=8)
    model = lm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    step = engine.make_jitted_serve_step(one_rank, cfg)
    a = lm.decode_state_init(cfg, 2, 8, "cpu")
    b = lm.decode_state_init(cfg, 2, 8, "cpu")
    calls = []
    prev = cm.set_linear_hook(lambda *args: calls.append(1))
    try:
        for t in range(3):
            tok = torch.tensor([[1 + t], [7 - t]])
            got, a = step(model, tok, a, t)
            cm.set_linear_hook(None)
            want, b = lm.decode_step(model, tok, b, t)
            cm.set_linear_hook(lambda *args: calls.append(1))
            assert torch.equal(got, want)
            assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b)
                       for k in x)
    finally:
        cm.set_linear_hook(prev)
    assert calls == []


def test_one_rank_train_step_is_the_eager_step(one_rank):
    import copy

    import torch
    from repro_torch import configs
    from repro_torch.data import pipeline as pipe
    from repro_torch.models import common as cm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st
    cfg = cm.reduced(configs.get("smollm-360m"), vocab=128, n_layers=2)
    tcfg = st.TrainConfig(adamw=opt.AdamWConfig(lr=1e-3, warmup_steps=0))
    data = pipe.SyntheticLM(pipe.DataConfig(vocab=128, global_batch=2,
                                            seq_len=16))
    a = st.init_state(torch.Generator().manual_seed(0), cfg, tcfg, "cpu")
    b = copy.deepcopy(a)
    fn = st.make_jitted_train_step(one_rank, cfg, tcfg)
    for i in range(2):
        a, ma = fn(a, data.batch_at(i))
        b, mb = st.train_step(b, data.batch_at(i), cfg, tcfg)
        assert torch.equal(ma["loss"], mb["loss"])
    for (n, x), y in zip(a["params"].state_dict().items(),
                         b["params"].state_dict().values()):
        assert torch.equal(x, y), n


# -- training across ranks ---------------------------------------------------

def test_trainer_on_mesh_matches_one_process(results):
    """3 steps of `Trainer(mesh=(2, 2))`, loss rtol 1e-4 and params rtol
    2e-3 / atol 2e-4 against the one-process step (JAX's hold)."""
    r = results["trainer"]
    print(f"trainer: losses {r['losses']} vs {r['ref_losses']}, params "
          f"{r['param_ratio']:.3g} of the hold (worst {r['worst']})")
    assert r["step"] == 3
    np.testing.assert_allclose(r["losses"], r["ref_losses"], rtol=1e-4)
    assert r["param_ratio"] <= 1.0
    assert "stack.0.ffn.wi.w" in r["params_on_model"]
    assert r["steps_saved"] == [2, 3]


def _restore_plain(ckpt_dir, step):
    """The checkpoint restored into one process's fresh state."""
    import torch

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import pipeline as pipe
    from repro_torch.models import common as cm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st
    _, cfg, tcfg, _, _ = _dist_worker._loop_setup(st, opt, cm, configs,
                                                  pipe, "")
    state = st.init_state(torch.Generator().manual_seed(0), cfg, tcfg,
                          "cpu")
    state, got = CheckpointManager(str(ckpt_dir)).restore(state, step=step)
    assert got == step
    return state


def _assert_same_directory(a, b, names=True):
    """Two step directories with the same files, byte for byte, and the
    same manifest apart from its time (and the leaves' names, which
    differ between the packages, where `names` is false)."""
    ma = json.loads((a / "manifest.json").read_text())
    mb = json.loads((b / "manifest.json").read_text())
    if not names:
        for m in (ma, mb):
            for e in m["leaves"]:
                e.pop("name")
    assert ma["step"] == mb["step"] and ma["leaves"] == mb["leaves"]
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for e in ma["leaves"]:
        assert (a / e["file"]).read_bytes() == (b / e["file"]).read_bytes()


def test_mesh_checkpoint_is_what_one_process_writes(results, tmp_path):
    """The (2, 2) run's step-3 directory restores into one process bit
    for bit, and that process writes the same directory again."""
    import torch

    from repro_torch.checkpoint import CheckpointManager, manager
    src = results["dir"] / "mesh_ckpt"
    state = _restore_plain(src, 3)
    want = _dist_worker._file_leaves(str(src), 3)
    for (name, t), w in zip(manager.leaves(state), want):
        assert torch.equal(t, w), name
    CheckpointManager(str(tmp_path)).save(3, state)
    _assert_same_directory(src / "step_0000000003",
                           tmp_path / "step_0000000003")


@pytest.mark.parametrize("shape", ["4x1", "1x4"])
def test_elastic_restore_onto_other_meshes(results, shape):
    """The (2, 2) checkpoint restored by a `Trainer` on another mesh:
    every leaf bit for bit the file's, and leaves really sharded."""
    r = results["elastic"][shape]
    print(f"{shape}: {r['equal']} of {r['leaves']} leaves equal; "
          f"{len(r['sharded'])} sharded")
    assert r["equal"] == r["leaves"] and r["step"] == 3
    assert r["sharded"]
    if shape == "1x4":
        assert "params.stack.0.ffn.wi.w" in r["sharded"]


def test_jax_written_checkpoint_restores_onto_mesh(results):
    """The JAX manager's directory, restored onto (2, 2) and saved again
    from the placed state, comes back byte for byte."""
    assert results["jax_written"]["placed"]
    _assert_same_directory(results["dir"] / "jax_ckpt" / "step_0000000007",
                           results["dir"] / "jax_back" / "step_0000000007",
                           names=False)


# -- the sharded CoMeFa grid -------------------------------------------------

@pytest.mark.parametrize("g", [8, 3])
def test_sharded_grid_matches_unsharded(results, g):
    """8 slots shard 2 a rank; 3 do not divide 4 ranks and replicate."""
    r = results["grid"][f"g{g}"]
    print(f"g={g}: {r['placements']}, {r['held']} slots a rank, cycles "
          f"{r['totals']}")
    assert r["state_equal"] and r["rows_equal"] and r["rebuilt"]
    assert r["cycles"][0] == r["cycles"][1]
    assert r["per_slot"][0] == r["per_slot"][1]
    assert r["totals"][0] == r["totals"][1]
    assert r["dispatches"][0] == r["dispatches"][1] == 2
    if g == 8:
        assert r["held"] == 2 and "Shard(dim=0)" in r["placements"]
    else:
        assert r["held"] == 3 and "Replicate" in r["placements"]


@pytest.mark.parametrize("recode", ["None", "booth", "auto"])
def test_sharded_gemv_batched_equals_unsharded_and_jax(results, recode):
    from repro.kernels import comefa_sim as jcs
    r = results["grid"]["gemv"][recode]
    assert r["equal"] and r["stats"][0] == r["stats"][1]
    inp = np.load(results["dir"] / "grid_inputs.npz")
    got = np.load(results["dir"] / f"gemv_{recode}.npy")
    stats = {}
    want = jcs.comefa_gemv_batched(
        inp["w"], inp["x"], w_bits=4, x_bits=4,
        recode=None if recode == "None" else recode, stats=stats)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        got, np.einsum("gkn,gk->gn", inp["w"], inp["x"]))
    assert stats["cycles"] == r["stats"][1]["cycles"]
    assert stats["mode"] == r["stats"][1]["mode"]


def test_sharded_gemm_batched_equals_unsharded_and_jax(results):
    from repro.kernels import comefa_sim as jcs
    assert results["grid"]["gemm_equal"]
    inp = np.load(results["dir"] / "grid_inputs.npz")
    got = np.load(results["dir"] / "gemm.npy")
    want = jcs.comefa_gemm_batched(inp["a"], inp["b"], bits=3)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, inp["a"] @ inp["b"])


# -- the launcher on 2 gloo processes ----------------------------------------

def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _launch_two(tmp_path, steps):
    """`launch.train` as 2 processes of one gloo group; their outputs."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--fsdp", "--steps", str(steps), "--batch",
         "4", "--seq", "16", "--coordinator", f"localhost:{port}",
         "--num-processes", "2", "--process-id", str(i), "--ckpt",
         str(tmp_path / "ck")], cwd=tmp_path, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-2000:]
            outs.append(out.splitlines())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def test_train_launcher_on_two_processes_resumes(tmp_path):
    """`--fsdp --coordinator --num-processes --process-id` on 2 gloo
    processes: rank 0 alone prints, the run checkpoints, and a second
    run resumes from it."""
    first = _launch_two(tmp_path, 2)
    assert first[0][-1] == "finished at step 2" and first[1] == []
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_0000000002"]
    second = _launch_two(tmp_path, 4)
    assert "[trainer] resumed from step 2" in second[0]
    assert second[0][-1] == "finished at step 4" and second[1] == []
