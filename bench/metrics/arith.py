"""The benchmark's frozen arithmetic: peaks, the work of a kernel by its
shapes, the model FLOPs of a decode step, the busy union of device
intervals and the percentile over requests.

Everything here prices the work from shapes, whatever implements it: a
kernel replaced later is still priced by the projection it computes.
Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity),
which assume the card's full 700 W power limit.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense


def bitplane_bytes(m: int, k: int, n: int, bits: int,
                   act_bytes: int = 2) -> int:
    """Bytes one packed projection y[m, n] = x[m, k] @ W[k, n] must move:
    the w-bit planes and the f32 per-column scale read once, x read once
    and y written once in the activation dtype."""
    return bits * k * n // 8 + 4 * n + act_bytes * m * (k + n)


def matmul_flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def roofline_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    HBM bandwidth and the operations over the dense bf16 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)


def bitplane_bound_s(m: int, k: int, n: int, bits: int) -> float:
    return roofline_s(bitplane_bytes(m, k, n, bits), matmul_flops(m, k, n))


def expert_bytes(d_model: int, d_ff: int, act_bytes: int = 2) -> int:
    """One gated expert's three matrices (wi, wg [d, f], wo [f, d])."""
    return 3 * d_model * d_ff * act_bytes


def moe_bytes(routed_experts: int, tokens: int, d_model: int, d_ff: int,
              act_bytes: int = 2) -> int:
    """An MoE layer's call: the experts its tokens route to, read once,
    the tokens read once and the output written once."""
    return (routed_experts * expert_bytes(d_model, d_ff, act_bytes)
            + 2 * act_bytes * tokens * d_model)


def decode_token_flops(projections: Iterable[Tuple[int, int]], *,
                       head: Tuple[int, int], moe_layers: int = 0,
                       top_k: int = 0, d_model: int = 0, d_ff: int = 0,
                       n_experts: int = 0) -> int:
    """Model FLOPs one live token needs in a decode step, without
    attention: 2 x every weight it multiplies (the packed projections
    (K, N), the output head (d, V), and in an MoE layer the router and
    its top-k experts)."""
    flops = sum(2 * k * n for k, n in projections) + 2 * head[0] * head[1]
    flops += moe_layers * (2 * d_model * n_experts
                           + top_k * 2 * 3 * d_model * d_ff)
    return flops


def attention_flops(layers: int, n_heads: int, head_dim: int,
                    positions: int) -> int:
    """QK^T and PV of one query over `positions` cached keys, in every
    attention layer."""
    return layers * 2 * 2 * n_heads * head_dim * positions


def busy_union(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals: device time in
    which at least one operation ran, overlapping work counted once."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]]
              ) -> List[Tuple[float, float]]:
    """The gaps [end, next start) between the merged intervals."""
    gaps = []
    cur_e = None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        if cur_e is None or e > cur_e:
            cur_e = e
    return gaps


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    if not 0 < q <= 100:
        raise ValueError(f"percentile {q} outside (0, 100]")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]
