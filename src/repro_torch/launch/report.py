DOC = """Assemble the dry-run and roofline tables from
results/torch/{dryrun,roofline}/*.json.

The port of `repro.launch.report`, with H100 SXM figures.  Adds the
per-cell "useful-work" yardsticks that the raw roofline terms need for
a score:
  * compute yardstick: MODEL_FLOPS = 6*N_active*D (3x fwd for training)
  * memory yardstick: MODEL_BYTES = params (read once per step) + decode
    state traffic - the floor on HBM bytes
  * roofline fraction = yardstick_time(dominant resource) / bound_time -
    how close the counted step is to the best possible step on the
    dominant resource.
Param and state bytes come from the models built on the meta device.

  PYTHONPATH=src python -m repro_torch.launch.report [--results DIR]
"""
import argparse
import glob
import json
import os
from typing import Dict, Optional

from .dryrun import RESULTS, cell_config
from .roofline import HBM_BW, PEAK_FLOPS  # H100 SXM (NVIDIA data sheet)


def _param_bytes(arch: str, quant_bits: Optional[int] = None,
                 reduced: bool = False) -> int:
    from . import shapes as shapes_mod
    model = shapes_mod.param_structs(cell_config(arch, quant_bits, reduced))
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values())


def _state_bytes(arch: str, shape: str, reduced: bool = False) -> int:
    from . import shapes as shapes_mod
    states = shapes_mod.input_specs(
        arch, shape, cfg=cell_config(arch, None, reduced))["batch"]["states"]
    return sum(t.numel() * t.element_size()
               for st in states for t in st.values())


def model_bytes_per_chip(arch: str, shape: str, n_chips: int,
                         quant_bits: Optional[int] = None,
                         train: bool = False, reduced: bool = False) -> float:
    """Floor on HBM traffic per chip per step.

    train: params+opt state r/w (~6x params) + the residual-stream floor
    (each layer reads and writes the [tokens, d_model] stream at least
    once in fwd and once in bwd, and remat re-runs fwd: ~6 passes) -
    anything less would require fusing whole layers end to end.
    """
    from . import shapes as shapes_mod
    pb = _param_bytes(arch, quant_bits, reduced)
    if train:
        cfg = cell_config(arch, None, reduced)
        case = shapes_mod.SHAPES[shape]
        tokens = case.global_batch * case.seq_len
        act = tokens * cfg.d_model * 2 * 2 * cfg.n_layers * 3
        return (6.0 * pb + act) / n_chips
    sb = _state_bytes(arch, shape, reduced)
    return (pb + sb) / n_chips


def load(kind: str, results: str = RESULTS) -> Dict[str, dict]:
    out = {}
    for path in sorted(glob.glob(os.path.join(results, kind, "*.json"))):
        with open(path) as f:
            out[os.path.basename(path)[:-5]] = json.load(f)
    return out


def roofline_table(results: str = RESULTS) -> str:
    """Score definition:

    * train/prefill cells are compute/collective-bound on real hardware;
      the op-level memory sum is fusion-inflated (diagnostic only), so
      score = MODEL_FLOPS_time / max(compute_s, collective_s).
    * decode cells are genuinely memory-bound;
      score = MODEL_BYTES_time / memory_s.
    """
    rows = []
    cells = load("roofline", results)
    header = ("| arch | shape | compute_s | memory_s(diag) | collective_s "
              "| bound kind | useful-FLOP frac | roofline frac |\n"
              "|---|---|---|---|---|---|---|---|")
    for tag, r in cells.items():
        if r.get("rules_tag") or r.get("quant_bits"):
            continue
        train = r["shape"].startswith("train")
        decode = r["shape"].startswith(("decode", "long"))
        mb = model_bytes_per_chip(r["arch"], r["shape"], r["n_chips"],
                                  train=train,
                                  reduced=r.get("reduced", False))
        mem_yard = mb / HBM_BW
        comp_yard = r["model_flops_per_chip"] / PEAK_FLOPS
        if decode:
            bound, yard, kind = r["memory_s"], mem_yard, "memory"
        else:
            bound = max(r["compute_s"], r["collective_s"])
            yard = comp_yard
            kind = ("collective" if r["collective_s"] > r["compute_s"]
                    else "compute")
        frac = min(1.0, yard / bound) if bound else 0.0
        rows.append((r["arch"], r["shape"], r["compute_s"], r["memory_s"],
                     r["collective_s"], kind, r["useful_flops_frac"], frac))
    rows.sort()
    lines = [header]
    for a, s, c, m, co, dom, uf, fr in rows:
        lines.append(f"| {a} | {s} | {c:.4g} | {m:.4g} | {co:.4g} | {dom} "
                     f"| {uf:.1%} | {fr:.1%} |")
    return "\n".join(lines)


def dryrun_table(results: str = RESULTS) -> str:
    cells = load("dryrun", results)
    header = ("| arch | shape | mesh | FLOPs/chip | HBM GB/chip "
              "| collective MB/chip | compile s |\n|---|---|---|---|---|---|---|")
    lines = [header]
    for tag, r in sorted(cells.items()):
        mem = r.get("memory_analysis", {})
        hbm = (mem.get("argument_bytes", 0) + mem.get("temp_bytes", 0)) / 1e9
        coll = sum(r.get("collective_bytes", {}).values()) / 1e6
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['flops']:.3g} | {hbm:.1f} | {coll:.1f} "
            f"| {r.get('compile_s', 0)} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=DOC, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--results", default=RESULTS)
    args = ap.parse_args(argv)
    print("## Dry-run\n")
    print(dryrun_table(args.results))
    print("\n## Roofline\n")
    print(roofline_table(args.results))


if __name__ == "__main__":
    main()
