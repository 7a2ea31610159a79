"""The port's examples against the JAX package's: `comefa_programs_torch.py`
against `comefa_programs.py`, `quickstart_torch.py` against
`quickstart.py`.

The port's examples run the same sections on the port's simulator
(``--device cpu``: the uint8 reference engine), kernels' plain versions,
models and FPGA model; every line they print - the simulated cycle
counts, the Fig 9 speedups in both pricing modes, the 4-bit GEMM's error
and the quantized model's packed tensors - must equal the JAX example's.
"""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("REPRO_COMEFA_ENGINE", None)
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          *args], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.splitlines()


def test_comefa_programs_example_matches_jax():
    got = _run("comefa_programs_torch.py", "--device", "cpu")
    want = _run("comefa_programs.py")
    fig9 = [i for i, line in enumerate(want) if "(paper-formula" in line]
    assert len(fig9) == 7 and "'comefa-d': (6.7, 6.7)" in want[fig9[5]]
    assert [got[i] for i in fig9] == [want[i] for i in fig9]
    assert got == want


# the words that name the JAX package's device and oracle
QUICKSTART_WORDS = (("=== 2. TPU bit-plane kernel", "=== 2. Bit-plane kernel"),
                    ("smaller in HBM", "smaller in device memory"),
                    ("jnp oracle", "torch oracle"))


def test_quickstart_example_matches_jax():
    """The port's quickstart, on the CPU, prints the JAX quickstart's
    lines: the multiply's 76 cycles against the paper's 86 and its
    co-issue (86 instrs into 76), the 4-bit GEMM's rel err to 3
    decimals, the kernel equal to its oracle, the reduced SmolLM's 7
    packed tensors and finite logits (2, 16, 256) - with only the words
    that name the device and the oracle changed."""
    got = _run("quickstart_torch.py", "--device", "cpu")
    want = _run("quickstart.py")
    for old, new in QUICKSTART_WORDS:
        want = [line.replace(old, new) for line in want]
    assert got == want
    text = "\n".join(got)
    assert "paper formula n^2+3n-2 = 86" in text
    assert "kernel == torch oracle: True" in text
    assert "finite: True" in text
