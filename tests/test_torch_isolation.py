"""The port stands alone: no JAX and nothing of `repro`, no silent CPU.

`repro_torch` and `chip_smoke.py` must run where JAX is not installed, so
a fresh interpreter that imports every module of the port may hold no
``jax*`` and no ``repro`` / ``repro.*`` module afterwards, and no source
file may import one.  And where a caller asks for CUDA and there is
none, the port raises instead of quietly running on the CPU.
"""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import common as cm
from repro_torch.models import lm

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.launch.serve" in mods and len(mods) >= 20
    assert {f"repro_torch.launch.{m}" for m in (
        "shapes", "dryrun", "roofline", "report", "hillclimb")} <= set(mods)
    # importing every module starts no process group either
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cfg = cm.reduced(lm.Config(name="t", n_layers=1, d_model=64, n_heads=4,
                               kv_heads=2, d_ff=128, vocab=16))
    with pytest.raises(RuntimeError, match="cuda"):
        cm.device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        lm.decode_state_init(cfg, 1, 4)            # default device: cuda
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init(torch.Generator(), cfg)            # default device: cuda
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--reduced", "--quant", "8"])


def test_launcher_runs_on_cpu_when_asked(capsys):
    launch_serve.main(["--reduced", "--quant", "8", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "3", "--steps", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "generated token ids:" and len(lines) == 3


def test_new_entry_points_default_to_cuda(tmp_path):
    """The grid's mesh, a placed grid, the mesh trainer and the train
    launcher ask for CUDA unless told otherwise, and raise without it;
    none of them starts a process group on the way."""
    import torch.distributed as dist

    from repro_torch.core.comefa import grid as grid_mod
    from repro_torch.launch import train as launch_train
    from repro_torch.train import loop, step
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        grid_mod.grid_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        grid_mod.ComefaGrid(2)
    cfg = cm.reduced(lm.Config(name="t", n_layers=1, d_model=64, n_heads=4,
                               kv_heads=2, d_ff=128, vocab=16))
    trainer = loop.Trainer(cfg, step.TrainConfig(), loop.LoopConfig(
        ckpt_dir=str(tmp_path)), None)
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.init_or_restore()
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--reduced", "--steps", "1", "--fsdp"])
    assert not dist.is_initialized()
