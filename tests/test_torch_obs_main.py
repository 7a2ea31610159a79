"""`python -m repro_torch.obs` against `python -m repro.obs`.

Both run the same traced per-slot grid GEMV sweep (the port with
``--device cpu``, on the uint8 reference engine) and write a Chrome trace
and a metrics summary.  Wall-clock spans differ by nature (the port
stages operands on the device, so it has no host sync); the model-cycle
spans - every slot's load/compute/unload `Schedule` phases - and the
metrics summary's cycle counts must be equal.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.obs import __main__ as obs_main
from repro_torch.obs import trace

ROOT = Path(__file__).resolve().parents[1]
MODEL_PID = 2                      # obs.export: the modeled-cycles process


def _run(module, tmp_path, *extra):
    trace, summary = tmp_path / f"{module}.json", tmp_path / f"{module}.m.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("REPRO_COMEFA_ENGINE", None)
    out = subprocess.run(
        [sys.executable, "-m", module, "--trace", str(trace), "--metrics",
         str(summary), "--slots", "3", "--k", "10", *extra],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"wrote {trace}" in out.stdout
    events = json.loads(trace.read_text())["traceEvents"]
    model = sorted((e["name"], e["tid"], e["ts"], e["dur"]) for e in events
                   if e.get("ph") == "X" and e["pid"] == MODEL_PID)
    counters = json.loads(summary.read_text())["counters"]
    cycles = {k: v for k, v in counters.items() if "cycles" in k}
    return model, cycles


def test_obs_main_matches_jax(tmp_path):
    model, cycles = _run("repro_torch.obs", tmp_path, "--device", "cpu")
    want_model, want_cycles = _run("repro.obs", tmp_path)
    assert len(model) == 3 * 3 * 1 and model == want_model
    assert cycles == want_cycles
    assert cycles["comefa.kernel_cycles{kernel=gemv_batched,mode=per_slot}"] \
        > 0


def test_obs_main_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            obs_main.main(["--trace", str(tmp_path / "t.json")])
    finally:                       # main() armed the port's global tracer
        tracer = trace.get_tracer()
        tracer.enabled = False
        tracer.path = None
        tracer.clear()
