"""Which request ran in which slot at which batched step.

The serving engine's policy, as its documentation states it: before each
batched step every idle slot, lowest first, takes the next queued
request; a request replays its prompt one token a step and then emits
one token a step, so a request of prompt p and output s occupies p + s - 1
steps; a slot whose request retired with the queue empty stays idle and
repeats its last token at the next position.  The schedule depends on the
lengths alone, so the harness works it out without reading the program;
the program's own step count is checked against it.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..reference.dense_gqa import Entries


@dataclasses.dataclass
class Schedule:
    start: np.ndarray          # [N] first step of each request
    slot: np.ndarray           # [N] its slot
    length: np.ndarray         # [N] steps it occupies (p + s - 1)
    steps: int                 # batched steps of the whole run

    def end(self) -> np.ndarray:
        """[N] the step after each request's last."""
        return self.start + self.length

    def positions(self) -> List[Tuple[int, int]]:
        """(step, position) of every live token of the run."""
        return [(a + j, j) for a, n in zip(self.start, self.length)
                for j in range(n)]


def simulate(lengths: Sequence[Tuple[int, int]], slots: int) -> Schedule:
    """The schedule of requests (prompt, output) over `slots` slots."""
    n = len(lengths)
    if n < slots:
        raise ValueError(f"{n} requests cannot fill {slots} slots")
    occ = np.array([p + s - 1 for p, s in lengths], np.int64)
    start = np.zeros(n, np.int64)
    slot = np.zeros(n, np.int64)
    queue = deque(range(n))
    left = [0] * slots
    step = 0
    while queue or any(left):
        for g in range(slots):
            if left[g] == 0 and queue:
                r = queue.popleft()
                start[r], slot[r], left[g] = step, g, int(occ[r])
        step += 1
        left = [max(0, v - 1) for v in left]
    return Schedule(start, slot, occ, step)


def entries(sched: Schedule, prompts: Sequence[np.ndarray],
            outputs: Sequence[np.ndarray], *, requests=None,
            up_to: int = None, device="cpu") -> Entries:
    """The entries the reference replays, in (step, slot) order.

    With `requests`, only those requests' real tokens (enough for a model
    whose rows do not interact).  Otherwise every slot at every step up to
    `up_to` (default: the whole run), idle slots included, as a mixture of
    experts needs them: they share their step's routing groups.
    """
    rows = []                  # (step, slot, token, pos, seg, real)
    keep = None if requests is None else set(int(r) for r in requests)
    last_step = sched.steps if up_to is None else up_to
    for r in range(len(prompts)):
        if keep is not None and r not in keep:
            continue
        seq = np.concatenate([prompts[r], outputs[r][:-1]])
        a = int(sched.start[r])
        for j in range(min(int(sched.length[r]), last_step - a)):
            rows.append((a + j, int(sched.slot[r]), int(seq[j]), j, r, 1))
    if keep is None:
        # idle slots: from a slot's last retirement to the end of the run
        last = {}
        for r in range(len(prompts)):
            g = int(sched.slot[r])
            if g not in last or sched.start[r] > sched.start[last[g]]:
                last[g] = r
        for g, r in last.items():
            for t in range(int(sched.end()[r]), last_step):
                rows.append((t, g, int(outputs[r][-1]),
                             int(sched.length[r]), r, 0))
    rows.sort()
    a = torch.as_tensor(np.array(rows, np.int64).reshape(-1, 6),
                        device=device)
    return Entries(tokens=a[:, 2], pos=a[:, 3], seg=a[:, 4], step=a[:, 0],
                   row=a[:, 1], real=a[:, 5].bool())


def served(ent: Entries, prompts: Sequence[np.ndarray],
           outputs: Sequence[np.ndarray]) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(mask [E] of the entries whose logits chose a served token, the
    served token [n] of each, in entry order)."""
    seg = ent.seg.cpu().numpy()
    pos = ent.pos.cpu().numpy()
    real = ent.real.cpu().numpy()
    plen = np.array([len(p) for p in prompts])
    mask = real & (pos >= plen[seg] - 1)
    tok = [int(outputs[s][p - plen[s] + 1]) for s, p in
           zip(seg[mask], pos[mask])]
    return (torch.as_tensor(mask, device=ent.tokens.device),
            torch.as_tensor(tok, dtype=torch.long, device=ent.tokens.device))
