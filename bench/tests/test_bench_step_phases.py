"""The readers of the serving step's phases on a traced tiny cell on the
CPU: each reads a positive time, and together they read no more than the
steps they divide, start to start, over the same steps."""
import time

import pytest

from bench.harness import cell as cell_mod
from bench.harness import spec
from bench.tests import _tiny

SEED = 2 ** 31 + 424242
PHASES = ("decode.dispatch_ms_per_step", "decode.wait_ms_per_step",
          "serve.engine_ms_per_step")
# the mean step over the steps the phase readers take, from the start of
# its first phase (``serve.admit``) to the next step's: the interval the
# four phases of a step tile
STEP = {"name": "test.step_ms", "unit": "ms/step", "better": "lower",
        "source": "program_span", "layer": "model step",
        "moves": "serve_tokens_per_s", "workloads": ["tiny-serve"]}
STEP_READER = """
from bench.metrics import step_phases


def read(run):
    keep = step_phases.steps(run)
    starts = {int(s.attrs["step"]) - 1: s.ts
              for s in run.spans_named("serve.admit")}
    if not keep:
        return None
    return sum(starts[j + 1] - starts[j] for j in keep) / 1e3 / len(keep)
"""


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    root = _tiny.tiny_root(tmp_path_factory.mktemp("tiny"),
                           extra_per_layer=[STEP])
    (root / "bench" / "metrics" / "test.step_ms.py").write_text(STEP_READER)
    # seconds enough for steps on both sides of the profiled ones
    out = cell_mod.run_cell(spec.load_cell(root, "tiny-serve"), SEED, 4.0,
                            True, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    return {k: v["value"] for k, v in out["metrics"].items()}


def test_each_phase_reads_a_positive_time(traced):
    for name in PHASES:
        assert traced[name] > 0, name


def test_the_phases_sum_to_at_most_the_step(traced):
    total = sum(traced[name] for name in PHASES)
    assert total <= traced["test.step_ms"]
    # the phases tile the step: little of it lies between them
    assert total > 0.5 * traced["test.step_ms"]
