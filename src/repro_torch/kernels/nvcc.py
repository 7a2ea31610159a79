"""Build the port's CUDA sources into shared libraries with `nvcc`.

Each source in ``csrc/`` is compiled for ``sm_90a`` into a plain-C shared
library under ``_build/`` beside this file, keyed by a hash of the
source, at first use; the kernels' wrappers load it with `ctypes`.
`build` starts one `nvcc` per missing library, all at once, and waits for
them; `nvcc`'s own report (registers, shared memory, spills) is kept
beside each library with the suffix ``.log``.  `load` builds one source
and opens its library with its C functions' argument types declared.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def library(source: Path) -> Path:
    """Where the library built from `source` lives (hash of its text)."""
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{tag}.so"


def build(*sources: Path) -> List[Path]:
    """Compile every source whose library is missing, in parallel.

    Returns the libraries' paths in the order of `sources`; raises if
    `nvcc` is missing or any compile fails.
    """
    outs = [library(s) for s in sources]
    todo = [(s, o) for s, o in zip(sources, outs) if not o.exists()]
    if not todo:
        return outs
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "with the CUDA toolkit on the GPU's machine")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs.append((out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for out, tmp, proc in procs:
        report, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{out.name}: nvcc failed ({proc.returncode}):\n"
                          f"{report}")
            continue
        out.with_suffix(".log").write_text(report)
        os.replace(tmp, out)      # atomic: concurrent builders never race
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(source: Path, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build `source` if needed and open its library, declaring each named
    C function's argument types; every one returns an int (a cudaError_t).
    """
    lib = ctypes.CDLL(str(build(source)[0]))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
