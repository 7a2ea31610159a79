"""The work of the absorbed MLA decode (`kernels/mla_decode` in the port),
priced from shapes and the schedule's positions, read by
`mla_decode_roofline`: one call takes every slot of a step, each slot's
query of H heads of (latent + rope) over its cached rows 0..pos."""
from __future__ import annotations

from typing import List

from bench.metrics import arith


def slot_positions(sched, step: int, slots: int) -> List[int]:
    """Each slot's position at batched `step`: a live request's step
    within it; a slot idle since its last request retired repeats that
    request's next position, where the engine left it."""
    pos = [0] * slots
    begun = [-1] * slots
    for start, slot, length in zip(sched.start, sched.slot, sched.length):
        if start <= step and start > begun[slot]:
            begun[slot] = int(start)
            pos[slot] = int(min(step - start, length))
    return pos


def call_bytes(positions: List[int], heads: int, latent: int, rope: int,
               act_bytes: int = 2) -> int:
    """Bytes one call must move: each slot's rows 0..pos of the latent
    and RoPE key read once, the queries read once and the outputs
    written once, in the activation dtype."""
    rows = sum(p + 1 for p in positions)
    b = len(positions)
    return act_bytes * (rows * (latent + rope) + b * heads * (latent + rope)
                        + b * heads * latent)


def call_flops(positions: List[int], heads: int, latent: int,
               rope: int) -> int:
    """2 x (scores over latent + rope, then the weighted sum over the
    latent) a head and a row."""
    return 2 * heads * (latent + rope + latent) * sum(p + 1 for p in
                                                      positions)


def bound_s(run, first: int, steps: int) -> float:
    """The least time of every MLA layer's call over `steps` batched
    steps from `first`: `arith.roofline_s` of each call, summed."""
    m = run.cell.config["model"]
    layers = mla_layers(m)
    total = 0.0
    for step in range(first, first + steps):
        pos = slot_positions(run.sched, step, run.slots)
        total += layers * arith.roofline_s(
            call_bytes(pos, m["n_heads"], m["kv_lora_rank"],
                       m["qk_rope_dim"]),
            call_flops(pos, m["n_heads"], m["kv_lora_rank"],
                       m["qk_rope_dim"]))
    return total


def mla_layers(model: dict) -> int:
    kinds = model["pattern"]
    return sum(1 for j in range(model["n_layers"])
               if kinds[j % len(kinds)][0] == "mla")
