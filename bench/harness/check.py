"""Whether what the window served is correct.

Once the window has closed and the program's state is freed, the plain
reference (the one the configuration names, `bench/reference/`) replays
the tokens the server stepped and judges them:

* ``logit_gap``: over a sample of the finished requests drawn from the
  seed, the longest among them, the widest gap by which a served token's
  reference logit lies below the reference's best at that position
  (valid because the mixes decode greedily);
* for a cell whose limits file says ``"follow": "stages"`` (the
  mixture of experts, whose routing makes two roundings of the whole
  model part, see PERF.md), the check follows the served model stage by
  stage from its own recorded inputs, over every entry of the window:
  ``stage_err``, for each stage (the embedding, each layer, and the
  head from the served last layer's output) and each slot, the median
  over that slot's entries of |served output - reference output| /
  |reference output|, the largest over stages and slots (a routing
  choice that rounding tipped moves a few entries, which no slot's
  median sees; a fault on any slot moves that slot's median); and
  ``token_mismatch``, the served tokens that are not the argmax of the
  logits the server computed for them (the limit is 0);
* ``schedule_steps``: the program's batched steps against the schedule
  the engine's policy gives (the limit is 0);
* ``failed``: requests that came back with a wrong number of tokens or a
  token outside the vocabulary (the limit is 0).

`readings` gives the numbers alone, and the control's beside them
(`bench/calibrate.py` sets the limits from those).
"""
from __future__ import annotations

import sys
from typing import Callable, Dict, List

import numpy as np
import torch

from . import schedule

FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 (saturating), back in float32."""
    return t.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(
        torch.float32)


def sample(run, target_tokens: int) -> List[int]:
    """Requests to compare: the two longest, then others drawn from the
    seed until the sample holds `target_tokens` served tokens."""
    lengths = [len(r.prompt) + r.steps for r in run.requests]
    order = sorted(range(len(lengths)), key=lambda i: (-lengths[i], i))
    picked = order[:2]
    rng = np.random.default_rng([int(run.seed), 0x5a3])
    for i in rng.permutation(order[2:]):
        if sum(run.requests[j].steps for j in picked) >= target_tokens:
            break
        picked.append(int(i))
    return sorted(picked)


def logits(cell, run, picked, dev, act: Callable):
    """(the reference's logits at the served tokens of the `picked`
    requests, those tokens)."""
    prompts = [r.prompt for r in run.requests]
    ent = schedule.entries(run.sched, prompts, run.outputs,
                           requests=picked, device=dev)
    mask, tok = schedule.served(ent, prompts, run.outputs)
    return cell.reference().forward(run.float_weights,
                                    cell.config["model"], ent, mask,
                                    act=act), tok


def gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """[n] how far each token's logit lies below the best."""
    return ref_logits.max(-1).values - \
        ref_logits.gather(1, tokens[:, None])[:, 0]


def failed_requests(run) -> int:
    vocab = int(run.cell.config["model"]["vocab"])
    return sum(1 for r, o in zip(run.requests, run.outputs)
               if len(o) != r.steps or (len(o) and (o.min() < 0 or
                                                   o.max() >= vocab)))


def _relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[E] |a - b| / |b| row by row."""
    return (a - b).norm(dim=-1) / b.norm(dim=-1).clamp(min=1e-30)


def worst_slot_median(err: torch.Tensor, row: torch.Tensor) -> float:
    """The largest over slots of the median of `err` [E] over the
    entries of each slot (`row` [E])."""
    return max(float(err[row == g].median()) for g in torch.unique(row))


def stage_readings(cell, run, dev, control: bool) -> Dict:
    """`stage_err` and `token_mismatch` over every entry of the window
    (and with `control` the control's stage error, and `head_gap`, the
    widest gap of the served tokens under the reference's head, for the
    record), from the served model's recorded stage inputs."""
    prompts = [r.prompt for r in run.requests]
    ent = schedule.entries(run.sched, prompts, run.outputs, device=dev)
    mask, tok = schedule.served(ent, prompts, run.outputs)
    log = run.layer_log
    # the spill row past `log.steps` is not the window's
    io, out = log.io[:log.steps], log.logits[:log.steps]
    inputs = [io[:, j, :, 0].reshape(len(ent), -1).to(torch.float32)
              for j in range(io.shape[1])]
    served = out[:, :, -1].reshape(len(ent), -1)[mask].to(torch.float32)
    ref_mod, model = cell.reference(), cell.config["model"]
    outs, head = ref_mod.stages(run.float_weights, model, ent, inputs, mask)

    def worst(got, want):
        return max([worst_slot_median(_relative(g, w), ent.row)
                    for g, w in zip(got, want)] +
                   [worst_slot_median(_relative(got[-1], head),
                                      ent.row[mask])])
    out = {"stage_err": worst(inputs[:len(outs)] + [served], outs),
           "token_mismatch": int((served.argmax(-1) != tok).sum())}
    if control:
        low, low_head = ref_mod.stages(run.float_weights, model, ent,
                                       inputs, mask, act=fp8)
        out["control_stage_err"] = worst(low + [low_head], outs)
        out["head_gap"] = float(gap(head, tok).max())
        out["control_head_gap"] = float(
            gap(head, low_head.argmax(-1)).max())
        out["compared_tokens"] = int(tok.numel())
    return out


def readings(cell, run, dev, control: bool = False) -> Dict:
    """The numbers compared, and with `control` the control's beside
    them."""
    out = {"schedule_steps": abs(int(run.stats["steps"]) - run.sched.steps),
           "failed": failed_requests(run)}
    if run.layer_log is not None:
        out.update(stage_readings(cell, run, dev, control))
        return out
    picked = sample(run, int(cell.limits["sample_tokens"]))
    ref, tok = logits(cell, run, picked, dev, lambda t: t)
    gaps = gap(ref, tok)
    out["logit_gap"] = float(gaps.max())
    out["logit_gap_median"] = float(gaps.median())
    if control:
        low, _ = logits(cell, run, picked, dev, fp8)
        low_gaps = gap(ref, low.argmax(-1))
        out["control_logit_gap"] = float(low_gaps.max())
        out["control_logit_gap_median"] = float(low_gaps.median())
        out["compared_tokens"] = int(tok.numel())
    return out


def judge(cell, got: Dict, attempted: int) -> Dict:
    """The result line's `correct`, `attempted`, `failed` and `checks`
    from the `readings` `got`; the numbers and their limits also go to
    standard error, last."""
    limits = cell.limits["limits"]
    checks = {k: {"value": got[k], "limit": limits[k]} for k in limits
              if k in got}
    missing = [k for k in limits if k not in got]
    correct = not missing and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    for k in missing:
        print(f"check {k}: not read", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    return {"correct": bool(correct), "attempted": attempted,
            "failed": got["failed"], "checks": checks}
