"""`serve.captured_step_share` on a traced tiny cell on the CPU, where
every step is eager, and on counters made up for a run whose every step
replayed the captured graph, or that counted no steps (a program
without the counter)."""
import importlib.util
import time

import pytest

from bench.harness import cell as cell_mod
from bench.harness import spec
from bench.tests import _tiny

SEED = 2 ** 31 + 777777
NAME = "serve.captured_step_share"


def _reader():
    path = _tiny.REPO / "bench" / "metrics" / f"{NAME}.py"
    mod_spec = importlib.util.spec_from_file_location("share", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def _run(counters):
    return cell_mod.Run(cell=None, cfg=None, seed=0, setup_s=0.0,
                        window_s=1.0, requests=[], outputs=[], stats={},
                        sched=None, projections=[], counters=counters)


def test_a_tiny_cpu_run_replays_no_step(tmp_path):
    root = _tiny.tiny_root(tmp_path)
    out = cell_mod.run_cell(spec.load_cell(root, "tiny-serve"), SEED, 1.0,
                            True, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["metrics"][NAME] == {"value": 0.0, "unit": "%"}


@pytest.mark.parametrize("counters,want", [
    ({"serve.decode_steps": 1001.0,
      "serve.decode_steps{mode=graph}": 1001.0}, 100.0),
    ({"serve.decode_steps": 40.0, "serve.decode_steps{mode=graph}": 30.0,
      "serve.decode_steps{mode=eager}": 10.0}, 75.0),
    ({"serve.requests_completed": 12.0}, None)])
def test_the_share_of_the_counted_steps(counters, want):
    assert _reader().read(_run(counters)) == want
