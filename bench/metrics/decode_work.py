"""The work of the window's decode steps, read by `decode.mfu`."""
from __future__ import annotations

import numpy as np

from bench.metrics import arith


def step_flops(run) -> np.ndarray:
    """[steps] model FLOPs of each batched step: every live token's
    weights (`arith.decode_token_flops`) and its attention over the
    positions cached so far, its own included."""
    m = run.cell.config["model"]
    kinds = [tuple(k) for k in m["pattern"]]
    layer_kinds = [kinds[j % len(kinds)] for j in range(m["n_layers"])]
    moe_layers = sum(1 for _, f in layer_kinds if f == "moe")
    attn_layers = sum(1 for a, _ in layer_kinds
                      if a in ("global", "local"))
    per_token = arith.decode_token_flops(
        [(k, n) for _, k, n in run.projections],
        head=(m["d_model"], m["vocab"]), moe_layers=moe_layers,
        top_k=m.get("top_k", 0), d_model=m["d_model"], d_ff=m["d_ff"],
        n_experts=m.get("n_experts", 0))
    out = np.zeros(run.sched.steps, np.float64)
    for step, pos in run.sched.positions():
        out[step] += per_token + arith.attention_flops(
            attn_layers, m["n_heads"], m["head_dim"], pos + 1)
    return out


def mfu(run):
    """Model FLOPs of the window's steps over their host-clock time, as a
    share of the bf16 peak (%); each step's time runs from its
    `serve.batch_step` span's start to the next one's, and the steps the
    profiler ran over (and the one that stopped it) are left out."""
    starts = run.step_starts()
    if len(starts) < 2:
        return None
    flops = step_flops(run)
    skip = range(0)
    if run.trace is not None:
        a = run.trace.first_step
        skip = range(a, a + run.trace.steps + 1)
    f = t = 0.0
    for j in sorted(starts):
        if j + 1 in starts and j not in skip:
            f += flops[j]
            t += (starts[j + 1] - starts[j]) / 1e6
    if t <= 0:
        return None
    return 100.0 * f / t / arith.BF16_FLOP_PER_S
