"""The port's training loop end to end on the CPU: reduced SmolLM (two
layers, vocab 128), batches of 8 x 64 from the synthetic pipeline, as
the JAX package's `test_train_loop.py` sets it up.  The loss decreases,
a restart resumes at the saved step and equals, bit for bit, a run that
never stopped, the straggler watchdog fires, a microbatched step equals
the unsplit one, and checkpoints round-trip, garbage-collect, fall back
past a corrupt one, save asynchronously, and read and write the JAX
package's checkpoint format.  The training launcher and the example run.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jax_manager
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager, manager
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import common
from repro_torch.train import loop as loop_mod
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_mod

ROOT = Path(__file__).resolve().parents[1]


def _setup(tmp_path, total_steps=24, microbatches=1, int8=False):
    cfg = common.reduced(configs.get("smollm-360m"), vocab=128, n_layers=2)
    tcfg = step_mod.TrainConfig(
        adamw=opt.AdamWConfig(lr=3e-3, warmup_steps=5,
                              total_steps=total_steps,
                              int8_second_moment=int8),
        microbatches=microbatches)
    lcfg = loop_mod.LoopConfig(total_steps=total_steps, ckpt_every=8,
                               ckpt_dir=str(tmp_path), log_every=100)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, global_batch=8,
                                  seq_len=64, seed=5))
    return cfg, tcfg, lcfg, data


def _trainer(cfg, tcfg, lcfg, data):
    return loop_mod.Trainer(cfg, tcfg, lcfg, data, device="cpu")


def _leaves(state):
    """Every tensor of a train state by checkpoint name."""
    return dict(manager.leaves(state))


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), k


def test_loss_decreases(tmp_path):
    cfg, tcfg, lcfg, data = _setup(tmp_path)
    tr = _trainer(cfg, tcfg, lcfg, data)
    losses = []
    tr.run(tr.init_or_restore(),
           on_step=lambda s, st, m: losses.append(float(m["loss"])))
    assert len(losses) == 24
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    assert last < first - 0.1, (first, last)


def test_restart_resumes_from_checkpoint(tmp_path, capsys):
    cfg, tcfg, lcfg, data = _setup(tmp_path, total_steps=16)
    tr1 = _trainer(cfg, tcfg, lcfg, data)
    tr1.run(tr1.init_or_restore())
    assert tr1.ckpt.all_steps() == [8, 16]
    # "crash" and restart with a higher target
    tr2 = _trainer(cfg, tcfg, dataclasses.replace(lcfg, total_steps=20),
                   data)
    state = tr2.init_or_restore()
    assert int(state["step"]) == 16               # resumed, not restarted
    assert "[trainer] resumed from step 16" in capsys.readouterr().out
    assert int(tr2.run(state)["step"]) == 20


@pytest.mark.parametrize("int8", [False, True])
def test_restart_is_bitwise_deterministic(tmp_path, int8):
    """run(0..12) == run(0..8) + restart + run(8..12): params, moments
    (the int8 ones too) and step bit for bit; no data lost or repeated."""
    cfg, tcfg, lcfg, data = _setup(tmp_path, total_steps=12, int8=int8)
    lcfg = dataclasses.replace(lcfg, ckpt_every=4,
                               ckpt_dir=str(tmp_path / "a"))
    tr = _trainer(cfg, tcfg, lcfg, data)
    s_full = tr.run(tr.init_or_restore())

    lcfg_b8 = dataclasses.replace(lcfg, total_steps=8,
                                  ckpt_dir=str(tmp_path / "b"))
    trb = _trainer(cfg, tcfg, lcfg_b8, data)
    trb.run(trb.init_or_restore())
    trb2 = _trainer(cfg, tcfg, dataclasses.replace(lcfg_b8, total_steps=12),
                    data)
    sb = trb2.init_or_restore()
    assert int(sb["step"]) == 8
    _assert_states_equal(s_full, trb2.run(sb))


def test_straggler_watchdog(tmp_path, capsys):
    cfg, tcfg, lcfg, data = _setup(tmp_path, total_steps=10)
    tr = _trainer(cfg, tcfg, lcfg, data)
    orig = tr.step_fn

    def slow_step(s, b):                 # the sleep lands inside the timing
        slow = int(s["step"]) == 8
        out = orig(s, b)
        if slow:
            time.sleep(max(0.5, 5 * float(np.median(tr.step_times))))
        return out

    tr.step_fn = slow_step
    tr.run(tr.init_or_restore())
    assert tr.straggler_events >= 1
    assert "[watchdog] step 8 took" in capsys.readouterr().out


def test_microbatched_matches_unbatched(tmp_path):
    """Gradient accumulation over four equal slices keeps the numerics:
    loss within 1e-5 and params within 1e-4 relative after a step (the
    learning rate of step 0 is 0, so the test takes two)."""
    cfg, tcfg1, _, data = _setup(tmp_path, total_steps=4)
    tcfg4 = dataclasses.replace(tcfg1, microbatches=4)
    s1 = step_mod.init_state(torch.Generator().manual_seed(0), cfg, tcfg1,
                             "cpu")
    s4 = step_mod.init_state(torch.Generator().manual_seed(0), cfg, tcfg4,
                             "cpu")
    for step in range(2):
        s1, m1 = step_mod.train_step(s1, data.batch_at(step), cfg, tcfg1)
        s4, m4 = step_mod.train_step(s4, data.batch_at(step), cfg, tcfg4)
        np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m1["grad_norm"]),
                                   float(m4["grad_norm"]), rtol=1e-5)
    for (name, a), b in zip(s1["params"].named_parameters(),
                            s4["params"].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(tcfg, seed=0, steps=0, data=None, cfg=None):
    cfg = cfg or common.reduced(configs.get("smollm-360m"), vocab=128,
                                n_layers=2)
    s = step_mod.init_state(torch.Generator().manual_seed(seed), cfg, tcfg,
                            "cpu")
    for step in range(steps):
        s, _ = step_mod.train_step(s, data.batch_at(step), cfg, tcfg)
    return s


def test_checkpoint_round_trip_and_format(tmp_path):
    """Every leaf back bit for bit (bf16 moments among them), in the JAX
    manifest layout: shard names, sha256, shape and dtype per leaf, the
    step, leaf names from the state's dotted paths."""
    _, tcfg, _, data = _setup(tmp_path)
    saved = _state(tcfg, steps=2, data=data)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    d = mgr.save(2, saved)
    assert os.path.basename(d) == "step_0000000002"
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    names = [e["name"] for e in manifest["leaves"]]
    assert manifest["step"] == 2
    want = [f"params.{k}" for k in saved["params"].state_dict()]
    want += [f"opt.{n}.{k}" for n, st in saved["opt"].items() for k in st]
    assert names == want + ["step"]
    assert names[0] == "params.embed.e" and names[-1] == "step"
    by_name = {e["name"]: e for e in manifest["leaves"]}
    assert by_name["opt.embed.e.m"]["dtype"] == "bfloat16"
    assert by_name["step"] == {**by_name["step"], "shape": [],
                               "dtype": "int32"}
    assert sorted(os.listdir(d)) == sorted(
        ["manifest.json"] + [f"shard_{i:05d}.bin" for i in range(len(names))])
    fresh = _state(tcfg, seed=1)
    restored, step = mgr.restore(fresh)
    assert step == 2 and restored is fresh
    _assert_states_equal(saved, fresh)


def test_checkpoint_keep_last_gc(tmp_path):
    _, tcfg, _, _ = _setup(tmp_path)
    s = _state(tcfg)
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, s)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                            "step_0000000004"]


def test_checkpoint_corruption_falls_back(tmp_path):
    """A shard whose bytes no longer match its checksum makes the newest
    checkpoint invalid; restore takes the one before it."""
    _, tcfg, _, data = _setup(tmp_path)
    old, new = _state(tcfg, steps=1, data=data), _state(tcfg, seed=2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, old)
    d = mgr.save(2, new)
    with open(os.path.join(d, "shard_00000.bin"), "r+b") as f:
        f.write(b"\xff\xff\xff\xff")
    target = _state(tcfg, seed=3)
    _, step = mgr.restore(target)
    assert step == 1
    _assert_states_equal(old, target)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(target)


def test_async_save_copies_before_the_next_update(tmp_path):
    """`save(blocking=False)` copies the state to host memory before its
    thread starts: a step that then updates the state in place does not
    reach the checkpoint."""
    _, tcfg, _, data = _setup(tmp_path)
    cfg = common.reduced(configs.get("smollm-360m"), vocab=128, n_layers=2)
    s = _state(tcfg, steps=1, data=data)
    want = {k: v.clone() for k, v in _leaves(s).items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, s, blocking=False)
    step_mod.train_step(s, data.batch_at(1), cfg, tcfg)   # in place
    mgr.wait()
    assert mgr._thread is None and mgr.all_steps() == [1]
    target = _state(tcfg, seed=4)
    mgr.restore(target)
    got = _leaves(target)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not torch.equal(_leaves(s)["params.embed.e"],
                           want["params.embed.e"])


def test_checkpoint_mismatched_state_raises(tmp_path):
    _, tcfg, _, _ = _setup(tmp_path)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="float32 \\[3, 4\\]"):
        mgr.restore({"w": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match="1 leaves"):
        mgr.restore({"w": torch.zeros(3, 4), "b": torch.zeros(2)})


def test_checkpoints_cross_between_packages(tmp_path):
    """A directory the JAX manager wrote from numpy leaves (f32, int8,
    int32 and bf16, which it names ``bfloat16``) restores in the port,
    matched by position; the port's directory passes the JAX manager's
    checksum validation and restores there with the same bytes."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": rng.integers(-128, 128, (7,)).astype(np.int8),
            "c": np.asarray(11, np.int32),
            "d": np.asarray(rng.normal(size=(2, 3)), jnp.bfloat16)}
    jmgr = jax_manager.CheckpointManager(str(tmp_path / "jax"))
    jmgr.save(5, tree)
    # JAX flattens a dict in sorted key order, as these keys are
    like = {"a": torch.zeros(3, 5), "b": torch.zeros(7, dtype=torch.int8),
            "c": torch.zeros((), dtype=torch.int32),
            "d": torch.zeros(2, 3, dtype=torch.bfloat16)}
    port = CheckpointManager(str(tmp_path / "jax"))
    _, step = port.restore(like)
    assert step == 5
    for k in "abc":
        assert np.array_equal(like[k].numpy(), tree[k]), k
    assert like["d"].view(torch.int16).numpy().tobytes() == \
        tree["d"].tobytes()

    out = CheckpointManager(str(tmp_path / "port"))
    d = out.save(6, like)
    assert jmgr._validate(d)
    back, jstep = jax_manager.CheckpointManager(
        str(tmp_path / "port")).restore(tree)
    assert jstep == 6
    for k in tree:
        assert np.asarray(back[k]).tobytes() == tree[k].tobytes(), k
        assert np.asarray(back[k]).dtype == tree[k].dtype, k


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.splitlines()


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-small"])
def test_train_launcher_on_cpu(tmp_path, arch):
    """The launcher trains and prints where it finished; Whisper's
    batches carry frame embeddings for its encoder."""
    lines = _run(["-m", "repro_torch.launch.train", "--arch", arch,
                  "--reduced", "--device", "cpu", "--steps", "6",
                  "--batch", "4", "--seq", "16", "--microbatches", "2",
                  "--int8-v", "--ckpt", str(tmp_path / "ck")], tmp_path)
    assert lines[-1] == "finished at step 6"
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_0000000006"]


def test_train_example_runs(tmp_path):
    lines = _run([str(ROOT / "examples" / "train_lm_torch.py"), "--steps",
                  "3", "--batch", "4", "--seq", "16", "--device", "cpu",
                  "--ckpt", str(tmp_path / "ck")], tmp_path)
    assert lines[-1] == "done at step 3; straggler events: 0"
