#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, and the control.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--trace 0]

runs the cell once a seed in one process (a shorter window at the cell's
own load, long enough to finish its longest requests) and prints one
JSON line a seed: the numbers `correct` compares, as the run read them,
and beside them the control's: the plain reference put in the program's
place one precision step below what the configuration states (float8
e4m3 activations for bf16), read at the same positions of the same
requests.  The control has
to read above the limit; see `bench/limits/<workload>.json`.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    bench_run.set_environment()
    import torch
    torch.set_num_threads(1)
    from bench.harness import cell as cell_mod
    from bench.harness import spec
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(bench_run.ROOT, args.workload)
    print(f"card: {bench_run.nvidia_smi()}", file=sys.stderr)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = cell_mod.run_cell(cell, seed, args.seconds, False, "cuda", t0,
                              control=True)
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "readings": r["readings"],
                          "metrics": r["metrics"],
                          "run_s": time.perf_counter() - t0}), flush=True)
        del r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
