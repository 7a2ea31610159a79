DOC = """Roofline analysis from the counted dry run (H100 targets).

The port of `repro.launch.roofline`.  XLA's cost analysis counts a scan
body once, so the JAX tool lowers two reduced depths unrolled and
differences them.  The port counts the eager step (`launch.dryrun`), in
which every layer and every microbatch runs as its own ops, so a count
has no such hazard.  It still counts at two depths and differences them,
since the layers of a pattern period repeat exactly and one or two
periods count in seconds where a 35-layer Arctic step takes minutes:

  delta = cost(2 periods) - cost(1 period)   is one period's cost, and
  total = cost(1 period) + (n_periods_full - 1 + n_rem/len(pattern)) * delta,

exact for whole periods (the remainder's layers are priced as a share of
a period, as in JAX).  Microbatches are counted at the production count
(the accumulation loop runs them all).  Collective bytes difference the
same way (`dryrun.count_periods`).  An arch with a token loop (xLSTM's
sLSTM) is counted at three lengths as well and extrapolated to the
cell's by the quadratic through them (`dryrun.count_cell`).
A cell takes a few seconds to a few minutes on the CPU (`analysis_s`).

Terms per (arch x shape), single-pod 256-rank mesh, per rank (one H100):
  compute_s    = FLOPs / 989e12      (bf16 dense peak)
  memory_s     = bytes_accessed / 3.35e12
  collective_s = sum_kind bytes * ring_factor(kind) / 50e9
H100 SXM figures from NVIDIA's H100 data sheet (SXM part, dense, at its
700 W limit).  The link rate is one 400 Gb/s NDR InfiniBand NIC a GPU, as
a DGX H100 has (50 GB/s each way): both axes of a 16x16 mesh cross the
8-GPU NVLink domains, so the slower link bounds a ring over either.
ring_factor: all-reduce 2x (reduce-scatter + all-gather), others 1x; the
(n-1)/n ring terms are folded into the 50 GB/s link.

Writes results/torch/roofline/<cell>.json; `launch.report` renders the
tables.  --reduced and --mesh-shape are `launch.dryrun`'s.
"""
import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, Optional

from ..models.common import Config
from . import dryrun as dr
from . import shapes as shapes_mod

PEAK_FLOPS = 989e12          # bf16 dense, H100 SXM (NVIDIA data sheet)
HBM_BW = 3.35e12             # bytes/s, H100 SXM HBM3 (NVIDIA data sheet)
LINK_BW = 50e9               # bytes/s: one 400 Gb/s NDR NIC a GPU (DGX H100)
RING_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}


def model_flops(cfg: Config, tokens: int, kind: str) -> float:
    """6*N_active*D reference FLOPs (the 'useful compute' yardstick)."""
    n_active = 0
    for mixer, f in cfg.layer_kinds():
        d, hd = cfg.d_model, cfg.hd
        if mixer in ("global", "local", "bidir", "cross_global"):
            n_active += d * hd * (cfg.n_heads * 2 + cfg.kv_heads * 2)
            if mixer == "cross_global":
                n_active += d * hd * (cfg.n_heads * 2 + cfg.kv_heads * 2)
        elif mixer == "mlstm":
            n_active += d * hd * cfg.n_heads * 4 + 2 * d * cfg.n_heads
        elif mixer == "slstm":
            n_active += d * hd * cfg.n_heads * 4 * 2
        elif mixer == "rglru":
            w = cfg.lru_width or d
            n_active += 2 * d * w + 2 * w * w + cfg.conv_width * w
        if f == "mlp":
            n_active += 3 * d * cfg.d_ff
        elif f in ("moe", "moe_dense"):
            n_active += 3 * d * cfg.d_ff * cfg.top_k + d * cfg.n_experts
            if f == "moe_dense":
                n_active += 3 * d * cfg.d_ff
    n_active += cfg.vocab * cfg.d_model          # lm head
    mult = 3.0 if kind == "train" else 1.0       # fwd+bwd = 3x fwd
    return 2.0 * n_active * tokens * mult


def terms(total: Dict[str, Any]) -> Dict[str, Any]:
    """The roofline terms of per-rank counts: compute, memory and
    collective seconds, the dominant one and the bound."""
    compute_s = total["flops"] / PEAK_FLOPS
    memory_s = total["bytes"] / HBM_BW
    coll_s = sum(v * RING_FACTOR.get(k, 1.0)
                 for k, v in total["coll"].items()) / LINK_BW
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", coll_s), key=lambda t: t[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s, "dominant": dominant,
            "step_time_lower_bound_s": max(compute_s, memory_s, coll_s)}


def analyze_cell(arch: str, shape: str, quant_bits: Optional[int] = None,
                 overrides: Optional[Dict[str, Any]] = None,
                 rules_tag: str = "", save: bool = True,
                 reduced: bool = False, mesh_shape=None,
                 results: str = dr.RESULTS) -> Dict[str, Any]:
    overrides = dict(overrides or {})
    cfg = dataclasses.replace(dr.cell_config(arch, quant_bits, reduced),
                              **overrides)
    case = shapes_mod.SHAPES[shape]
    t0 = time.time()
    with dr.analysis_mesh("single", mesh_shape) as mesh:
        total = dr.count_periods(arch, shape, mesh, cfg, quant_bits)
        n_chips = mesh.size()
    t = terms(total)

    if case.kind in ("train", "prefill"):
        tokens = case.global_batch * case.seq_len
    else:
        tokens = case.global_batch                # 1 new token each
    mflops = model_flops(cfg, tokens, case.kind) / n_chips     # per rank
    bound = t["step_time_lower_bound_s"]
    result = {
        "arch": arch, "shape": shape, "quant_bits": quant_bits,
        "rules_tag": rules_tag, "overrides": {k: str(v) for k, v
                                              in overrides.items()},
        "reduced": reduced,
        "mesh_shape": list(mesh_shape) if mesh_shape else None,
        "n_chips": int(n_chips),
        "flops_per_chip": total["flops"],
        "bytes_per_chip": total["bytes"],
        "collective_bytes_per_chip": total["coll"],
        **t,
        "model_flops_per_chip": mflops,
        "useful_flops_frac": (mflops / total["flops"]
                              if total["flops"] else 0.0),
        "roofline_frac": ((mflops / PEAK_FLOPS) / bound) if bound else 0.0,
        "counting": "two depths differenced, production microbatches"
                    + (f", {total['lengths']} tokens extrapolated to the "
                       "cell's length" if total["lengths"] else ""),
        "analysis_s": round(time.time() - t0, 1),
    }
    if save:
        d = os.path.join(results, "roofline")
        os.makedirs(d, exist_ok=True)
        tag = f"{arch}__{shape}" + (f"__w{quant_bits}" if quant_bits else "")
        tag += f"__{rules_tag}" if rules_tag else ""
        with open(os.path.join(d, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=DOC, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--quant", type=int, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh-shape", default=None)
    ap.add_argument("--results", default=dr.RESULTS)
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    todo = ([(a, s) for a, s, skip in shapes_mod.cells() if not skip]
            if args.all else [(args.arch, args.shape)])
    fails = 0
    for arch, shape in todo:
        try:
            r = analyze_cell(arch, shape, quant_bits=args.quant,
                             reduced=args.reduced,
                             mesh_shape=dr.parse_mesh_shape(args.mesh_shape),
                             results=args.results)
            print(f"{arch:18s} {shape:12s} comp={r['compute_s']:.4f}s "
                  f"mem={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s "
                  f"dom={r['dominant']:10s} "
                  f"roofline={r['roofline_frac']:.2%}", flush=True)
        except Exception as e:   # report the cell, go on to the next
            fails += 1
            print(f"FAIL {arch} {shape}: {type(e).__name__}: {str(e)[:300]}",
                  flush=True)
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
