"""`examples/comefa_programs_torch.py` against `examples/comefa_programs.py`.

The port's example runs the same six sections on the port's simulator
(``--device cpu``: the uint8 reference engine) and the port's FPGA model;
every line it prints - the simulated cycle counts and the Fig 9 speedups
in both pricing modes - must equal the JAX example's.
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
