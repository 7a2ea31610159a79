DOC = """Perf hillclimbing runner: hypothesis -> change -> re-count -> record.

The port of `repro.launch.hillclimb`, on the port's roofline
(`launch.roofline`, H100 SXM figures).  The same three cells:
  A. gemma3-27b x decode_32k   - memory-bound decode; the cell the
     paper's technique targets (weight-stream bound GEMV == CoMeFa's
     OOOR GEMV).
  B. arctic-480b x train_4k    - the most collective-heavy cell.
  C. gemma2-27b x prefill_32k  - collective-heavy at inference.

Each iteration is a named (hypothesis, change) pair; the runner applies
the change (rules / config override / quant bits), re-runs the roofline
analysis, and appends before/after to
results/torch/hillclimb/<cell>.json.  Iterations whose change landed in
the JAX package's code (``bf16io``, ``bf16oh``) are re-analyses of the
same code under their tag, as in JAX.

Run: PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell A
     [--iters i1,i2] [--reduced --mesh-shape 4x2 --results DIR]
"""
import argparse
import copy
import json
import os
from typing import Any, Dict, List, Optional

from . import dryrun as dr
from . import roofline as rl


def _run(arch, shape, *, quant_bits=None, overrides=None, settings=None,
         tag="", **where):
    """Analyze one variant, optionally with patched TRAIN_SETTINGS;
    `where` carries `analyze_cell`'s reduced/mesh_shape/results."""
    saved = copy.deepcopy(dr.TRAIN_SETTINGS.get(arch))
    if settings is not None:
        cur = dict(saved or dr.DEFAULT_TRAIN)
        cur.update(settings)
        dr.TRAIN_SETTINGS[arch] = cur
    try:
        return rl.analyze_cell(arch, shape, quant_bits=quant_bits,
                               overrides=overrides, rules_tag=tag, **where)
    finally:
        if saved is None:
            dr.TRAIN_SETTINGS.pop(arch, None)
        else:
            dr.TRAIN_SETTINGS[arch] = saved


CELLS: Dict[str, Dict[str, Any]] = {
    "A": {
        "arch": "gemma3-27b", "shape": "decode_32k",
        "iterations": [
            {
                "name": "w4-bitplane-weights",
                "hypothesis": (
                    "decode is memory-bound on weight streaming; storing "
                    "every projection as 4-bit packed bit-planes (the "
                    "paper's technique) cuts weight bytes 4x -> memory "
                    "term should drop toward the KV-cache floor"),
                "kwargs": dict(quant_bits=4, tag="w4"),
            },
            {
                "name": "tp-only-inference-params",
                "hypothesis": (
                    "gemma3 decode inherits FSDP rules from training; at "
                    "inference the bf16 params, sharded over the model "
                    "axis, fit under pure TP, removing per-layer "
                    "all-gathers -> collective term shrinks"),
                "kwargs": dict(settings=dict(fsdp=False), tag="tponly"),
            },
            {
                "name": "w4+tp-only",
                "hypothesis": "both wins compose",
                "kwargs": dict(quant_bits=4, settings=dict(fsdp=False),
                               tag="w4tponly"),
            },
            {
                "name": "bf16-attention-io",
                "hypothesis": (
                    "the baseline memory term is many times the analytic "
                    "floor (weights + cache) because _sdpa casts q/k to "
                    "f32, materializing an f32 copy of the KV cache every "
                    "layer; reading bf16 operands with f32 accumulation "
                    "removes that copy -> memory term should drop ~2x or "
                    "more"),
                "kwargs": dict(tag="bf16io"),   # change landed in _sdpa
            },
            {
                "name": "bf16io+w4-kernel-analytic",
                "hypothesis": (
                    "iteration 1 (XLA-path w4) was REFUTED: op-level "
                    "accounting shows the int32 unpack materialization "
                    "*adds* bytes - the technique needs the fused "
                    "kernel, whose HBM traffic is analytic: packed weight "
                    "bytes (w/16 x) + unchanged cache/activations; "
                    "recorded via the bf16io measurement minus the "
                    "weight-stream delta"),
                "kwargs": dict(tag="bf16io-w4analytic"),
            },
        ],
    },
    "B": {
        "arch": "arctic-480b", "shape": "train_4k",
        "iterations": [
            {
                "name": "ep-compute",
                "hypothesis": (
                    "FSDP re-gathers 470B of expert weights every "
                    "microbatch; computing with experts resident (EP over "
                    "data) moves only the dispatched tokens - a large cut "
                    "of the dominant collective term"),
                "kwargs": dict(settings=dict(
                    rules={"moe_tokens": None}), tag="ep"),
            },
            {
                "name": "ep+fewer-microbatches",
                "hypothesis": (
                    "attention-weight gathers repeat per microbatch; "
                    "8->4 microbatches halves that traffic at 2x "
                    "activation memory (fits after EP removed the "
                    "expert buffers)"),
                "kwargs": dict(settings=dict(
                    rules={"moe_tokens": None}, microbatches=4), tag="epmb4"),
            },
            {
                "name": "bf16-routing-onehots",
                "hypothesis": (
                    "both EP iterations were REFUTED on collectives "
                    "(capacity-expanded token gathers outweigh model-"
                    "sharded weight gathers at 1M-token steps), and the "
                    "dominant term is memory: the f32 dispatch/combine "
                    "one-hot tensors ([n,g,e,c]) are the largest MoE "
                    "intermediates - casting dispatch to bf16 halves "
                    "them"),
                "kwargs": dict(tag="bf16oh"),   # change landed in ffn.py
            },
        ],
    },
    "C": {
        "arch": "gemma2-27b", "shape": "prefill_32k",
        "iterations": [
            {
                "name": "tp-only-inference-params",
                "hypothesis": (
                    "prefill inherits FSDP rules; TP-only removes the "
                    "per-layer weight all-gathers (27B x 2B x fwd) -> "
                    "collective term drops by ~that traffic"),
                "kwargs": dict(settings=dict(fsdp=False), tag="tponly"),
            },
            {
                "name": "tp-only+seq-parallel",
                "hypothesis": (
                    "with collectives fixed, the memory term (activation "
                    "traffic at 1M tokens) dominates; sharding the "
                    "sequence dim of activations over model between "
                    "layers (SP) cuts per-chip activation bytes ~16x for "
                    "the norm/residual segments"),
                "kwargs": dict(settings=dict(fsdp=False),
                               overrides=None, tag="tpsp",
                               extra_rules={"seq": ("model",)}),
            },
            {
                "name": "w4-weights-prefill",
                "hypothesis": (
                    "prefill at 1M tokens is compute-heavy, so w4 weights "
                    "should barely move the bound (negative control for "
                    "the technique: it targets GEMV-shaped cells, not "
                    "GEMM-shaped ones)"),
                "kwargs": dict(quant_bits=4, settings=dict(fsdp=False),
                               tag="w4tponly"),
            },
        ],
    },
}


def run_cell(cell_id: str, only: Optional[List[str]] = None,
             results: str = dr.RESULTS, reduced: bool = False,
             mesh_shape=None):
    cell = CELLS[cell_id]
    arch, shape = cell["arch"], cell["shape"]
    where = dict(results=results, reduced=reduced, mesh_shape=mesh_shape)
    out_dir = os.path.join(results, "hillclimb")
    os.makedirs(out_dir, exist_ok=True)
    log_path = os.path.join(out_dir, f"{cell_id}_{arch}_{shape}.json")
    log = {"cell": cell_id, "arch": arch, "shape": shape, "iterations": []}
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = json.load(f)

    have = {it["name"] for it in log["iterations"]}
    if "baseline" not in have:
        base = _run(arch, shape, tag="hc-base", **where)
        log["iterations"].append({"name": "baseline", "hypothesis": "",
                                  "result": base})
        have.add("baseline")
    for it in cell["iterations"]:
        if only and it["name"] not in only:
            continue
        if it["name"] in have:
            continue
        kwargs = dict(it["kwargs"])
        extra_rules = kwargs.pop("extra_rules", None)
        if extra_rules:
            settings = dict(kwargs.get("settings") or {})
            rules = dict(settings.get("rules") or {})
            rules.update(extra_rules)
            settings["rules"] = rules
            kwargs["settings"] = settings
        res = _run(arch, shape, **kwargs, **where)
        base = log["iterations"][0]["result"]
        entry = {
            "name": it["name"], "hypothesis": it["hypothesis"],
            "result": res,
            "delta": {
                k: (res[k], base[k],
                    (base[k] / res[k]) if res[k] else float("inf"))
                for k in ("compute_s", "memory_s", "collective_s",
                          "step_time_lower_bound_s")
            },
        }
        log["iterations"].append(entry)
        with open(log_path, "w") as f:
            json.dump(log, f, indent=1)
        d = entry["delta"]["step_time_lower_bound_s"]
        print(f"[{cell_id}] {it['name']}: bound {d[1]:.4f}s -> {d[0]:.4f}s "
              f"({d[2]:.2f}x)", flush=True)
    with open(log_path, "w") as f:
        json.dump(log, f, indent=1)
    return log


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=DOC, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cell", default="A", choices=list(CELLS) + ["all"])
    ap.add_argument("--iters", default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh-shape", default=None)
    ap.add_argument("--results", default=dr.RESULTS)
    args = ap.parse_args(argv)
    only = args.iters.split(",") if args.iters else None
    cells = list(CELLS) if args.cell == "all" else [args.cell]
    for c in cells:
        run_cell(c, only, results=args.results, reduced=args.reduced,
                 mesh_shape=dr.parse_mesh_shape(args.mesh_shape))


if __name__ == "__main__":
    main()
