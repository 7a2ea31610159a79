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
  JAX's, run here with ``jax.vmap(..., axis_name="pod")``.

Each config must really shard a leaf on "model", so that the holds
prove something.  The gaps are printed.  NCCL takes one rank a card, so
the multi-rank forms run on gloo here; the card runs the one-rank forms
(`chip_smoke.py` phase 18).
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import _dist_worker
from repro.parallel import compression as jcompression
from repro_torch.parallel import compression

SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Spawn the 4 ranks once for the whole file; a hang fails the tests
    after `SPAWN_TIMEOUT_S` instead of stalling the suite."""
    out = tmp_path_factory.mktemp("dist")
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


@pytest.mark.parametrize("case", ["train", "train_int8", "train_micro2"])
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


@pytest.mark.parametrize("case", ["decode_gemma2", "decode_smollm_q8"] + [
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
