#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for.  It prints one JSON line last on standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), `device`, with
``--trace 1`` a `breakdown`, and last the `checks` that decided
`correct`, each number beside its limit (also the last lines on standard
error).  It exits nonzero, with no result, where CUDA or the devices are
missing, where a piece of the cell is missing, or where the JAX package
or JAX is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# build and kernel caches at fixed paths inside the checkout, so that
# only a checkout's first run builds
CACHES = {"TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions",
          "TRITON_CACHE_DIR": ".bench_cache/triton"}
# one process that drives the card from one host thread: no CPU thread
# pools beside it to contend for the host's cores
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "OPENBLAS_NUM_THREADS": "1"}


def set_environment() -> None:
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)
    os.environ.update(THREADS)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def nvidia_smi() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    import torch
    torch.set_num_threads(1)
    from bench.harness import cell as cell_mod
    from bench.harness import spec

    cell = spec.load_cell(ROOT, args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    card = nvidia_smi()
    print(f"card: {card}", file=sys.stderr)
    result = cell_mod.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in the benchmark's process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips,
              "memory_peak_bytes": result.pop("memory_peak_bytes")}
    for key in ("busy_s", "window_s"):
        if key in result:
            device[key] = result.pop(key)
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": device}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["power_limit"] = card
    line["checks"] = result["checks"]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
