"""Sample traced sweep: ``python -m repro_torch.obs --trace trace.json``.

Runs a small per-slot-stream grid GEMV (`comefa_gemv_batched` with
``recode="naive"`` on a `ComefaGrid.run_per_slot` dispatch) with tracing
force-enabled, checks it against ``einsum`` and writes:

  * a Chrome trace-event JSON (wall-clock spans - encode, dispatch,
    host sync - plus the per-tile load/compute/unload model-cycle spans
    of every slot's `Schedule`), loadable in Perfetto;
  * optionally a flat metrics dump (``--metrics PATH``).

The grid runs on ``--device`` (default ``cuda``: the CUDA step kernel;
``--device cpu`` runs the uint8 reference engine).  The same path is
traced in any run with ``REPRO_TORCH_TRACE=path.json`` set.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..kernels import comefa_sim
from . import export, metrics, trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace", metavar="PATH", default="comefa-trace.json",
                    help="Chrome trace-event JSON output path")
    ap.add_argument("--metrics", metavar="PATH", default=None,
                    help="also write the flat metrics summary JSON")
    ap.add_argument("--slots", type=int, default=4,
                    help="grid slots in the sample sweep")
    ap.add_argument("--k", type=int, default=12, help="GEMV depth")
    ap.add_argument("--device", default="cuda",
                    help="torch device the grid runs on (default cuda)")
    args = ap.parse_args(argv)

    trace.configure(enabled=True, path=args.trace)

    rng = np.random.default_rng(0)
    g, k, n, w_bits, x_bits, acc_bits = args.slots, args.k, 160, 4, 6, 20
    w = rng.integers(0, 1 << w_bits, size=(g, k, n))
    x = rng.integers(0, 1 << x_bits, size=(g, k))
    with trace.span("sample.gemv_sweep", slots=g, k=k):
        y = comefa_sim.comefa_gemv_batched(
            w, x, w_bits=w_bits, x_bits=x_bits, acc_bits=acc_bits,
            recode="naive", device=args.device)
    if not np.array_equal(y, np.einsum("gkn,gk->gn", w, x)):
        raise SystemExit("sample sweep miscomputed")

    path = trace.flush()
    events = trace.get_tracer().events()
    n_wall = sum(1 for e in events if e.track == trace.WALL_TRACK)
    n_model = sum(1 for e in events if e.track == trace.MODEL_TRACK)
    print(f"wrote {path}: {n_wall} wall-clock + {n_model} model-cycle "
          f"spans from a {g}-slot run_per_slot GEMV sweep on "
          f"{args.device}")
    if args.metrics:
        with open(args.metrics, "w") as f:
            json.dump(export.metrics_summary(metrics.snapshot()), f,
                      indent=2)
            f.write("\n")
        print(f"wrote {args.metrics}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
