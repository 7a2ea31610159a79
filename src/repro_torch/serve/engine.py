"""Serving: prefill, batched decode and continuous batching.

The port of `repro.serve.engine`.  With cfg.quant_bits set, every
projection streams w-bit packed bit-plane weights through the bit-plane
kernel - the decode step is memory-bound, so weight bytes are the term
this feature attacks.

Sampling at temperature > 0 draws from an explicit `torch.Generator`; it
cannot reproduce `jax.random`, so only greedy tokens are comparable with
the JAX package.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models import common as cm
from ..models import lm
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

_QUEUE_DEPTH = obs_metrics.gauge("serve.queue_depth")
_REQUESTS_DONE = obs_metrics.counter("serve.requests_completed")


def prefill(params: lm.LM, tokens: torch.Tensor, max_len: int):
    """Process the prompt; returns (last-token logits, fresh decode state).

    As in the JAX package, the state comes back freshly initialised:
    `generate` primes the caches by replaying the prompt through decode.
    """
    b, s = tokens.shape
    with obs_trace.span("serve.prefill", batch=b, seq=s,
                        family=params.cfg.family):
        logits = lm.forward(params, tokens)
        states = lm.decode_state_init(params.cfg, b, max_len, params.device)
    return logits[:, -1:], states


def decode_step(params: lm.LM, token, states, index):
    return lm.decode_step(params, token, states, index)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0) -> torch.Tensor:
    """Next token per row from logits [B, S, V]: argmax at temperature 0,
    else a draw from softmax(logits / temperature) with `generator`."""
    last = logits[:, -1].to(torch.float32)
    if temperature == 0.0:
        return torch.argmax(last, dim=-1).to(torch.int32)
    probs = torch.softmax(last / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def generate(params: lm.LM, prompt, *, steps: int, max_len: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             executor=None) -> torch.Tensor:
    """Greedy/temperature generation; returns tokens [B, steps] int32.

    The prompt is replayed through the decode path to prime the caches,
    then `steps` tokens are sampled.  ``executor`` is installed as the
    packed-linear hook for the duration of the call (see
    `models.common.set_linear_hook`).  `generator` (on the model's
    device) drives sampling at temperature > 0; it defaults to one seeded
    with 0.
    """
    dev = params.device
    prompt = torch.as_tensor(prompt, device=dev)
    b, s = prompt.shape
    if s == 0:
        raise ValueError(
            "generate() needs a non-empty prompt (got shape "
            f"{tuple(prompt.shape)}): with no prompt tokens there are no "
            "logits to sample the first output token from")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    prev_hook = cm.set_linear_hook(executor) if executor is not None \
        else None
    try:
        states = lm.decode_state_init(params.cfg, b, max_len, dev)
        logits = None
        with obs_trace.span("serve.prime", batch=b, seq=s,
                            family=params.cfg.family):
            for t in range(s):
                with obs_trace.span("serve.prime_token", step=t):
                    logits, states = lm.decode_step(
                        params, prompt[:, t:t + 1], states, t)
        out = []
        tok = sample(logits, generator)
        for t in range(steps):
            out.append(tok)
            with obs_trace.span("serve.decode_step", step=t):
                logits, states = lm.decode_step(params, tok[:, None],
                                                states, s + t)
                tok = sample(logits, generator, temperature)
    finally:
        if executor is not None:
            cm.set_linear_hook(prev_hook)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# continuous batching: admit/retire requests between batched steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    """One serving request: a prompt to replay, then `steps` new tokens."""
    prompt: Any                      # [s] int tokens, s >= 1
    steps: int


def _request_generator(seed: int, rid: int, n: int,
                       dev: torch.device) -> torch.Generator:
    """A generator for emission `n` of request `rid`: a request's draws
    depend on (seed, rid, n) only, never on its batch neighbours."""
    mixed = np.random.SeedSequence([seed, rid, n]).generate_state(1)[0]
    return torch.Generator(device=dev).manual_seed(int(mixed))


def _reset_state_slot(states, fresh, slot: int) -> None:
    """Restore batch row `slot` of every decode-state tensor, in place,
    from row 0 of `fresh` (a batch-1 fresh init).  Every state tensor of
    the port keeps its batch on axis 0."""
    for layer, init in zip(states, fresh):
        for name, t in layer.items():
            t[slot].copy_(init[name][0])


def serve_continuous(params: lm.LM, requests: List[Request], *,
                     slots: int, max_len: int, temperature: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     executor=None,
                     stats: Optional[Dict] = None) -> List[np.ndarray]:
    """Token-level continuous batching over a fixed-width decode batch.

    Every step runs ONE batched decode over all `slots` rows at per-row
    sequence positions (the vector-`index` decode path); between steps,
    finished requests retire and queued requests take the freed rows.  A
    newly admitted request replays its prompt token by token in its row
    while other rows keep decoding.

    At temperature > 0, emission n of request r draws from a generator
    seeded by (seed, r, n), where seed is ``generator.initial_seed()``
    (0 without one), so a request's tokens do not depend on what it was
    batched with.

    Returns the emitted tokens per request, in submission order.  A
    ``stats`` dict receives ``steps`` (batched dispatches),
    ``occupancy`` (mean live-row fraction) and ``slot_steps``.
    """
    for i, r in enumerate(requests):
        if len(r.prompt) == 0:
            raise ValueError(f"request {i} has an empty prompt")
        if len(r.prompt) + r.steps > max_len:
            raise ValueError(f"request {i} needs {len(r.prompt) + r.steps}"
                             f" positions, max_len is {max_len}")
    dev = params.device
    seed = generator.initial_seed() if generator is not None else 0
    states = lm.decode_state_init(params.cfg, slots, max_len, dev)
    fresh = lm.decode_state_init(params.cfg, 1, max_len, dev)
    queue = deque(enumerate(requests))
    outputs: List[Optional[List[int]]] = [None] * len(requests)
    slot_req = [None] * slots        # request id per row, None = idle
    slot_pos = [0] * slots           # prompt tokens consumed per row
    slot_span = [None] * slots       # open serve.request span per row
    tok = np.zeros((slots, 1), np.int64)
    index = np.zeros((slots,), np.int64)
    step = slot_steps = 0
    prev_hook = cm.set_linear_hook(executor) if executor is not None \
        else None
    try:
        while queue or any(r is not None for r in slot_req):
            # admit: fill every idle row from the queue
            for g in range(slots):
                if slot_req[g] is not None or not queue:
                    continue
                rid, req = queue.popleft()
                _reset_state_slot(states, fresh, g)
                slot_req[g], slot_pos[g], index[g] = rid, 0, 0
                outputs[rid] = []
                tok[g, 0] = int(req.prompt[0])
                sp = obs_trace.span("serve.request", request=rid, slot=g,
                                    prompt=len(req.prompt),
                                    steps=req.steps)
                slot_span[g] = sp
                sp.__enter__()
            _QUEUE_DEPTH.set(len(queue))
            live = np.array([r is not None for r in slot_req])
            if executor is not None:
                executor.active_mask = live
            slot_steps += int(live.sum())
            step += 1
            with obs_trace.span("serve.batch_step", step=step,
                                live=int(live.sum())):
                logits, states = lm.decode_step(
                    params, torch.as_tensor(tok, device=dev), states,
                    torch.as_tensor(index, device=dev))
            greedy = torch.argmax(logits[:, -1], dim=-1).tolist() \
                if temperature == 0.0 else None
            # per-row advance: next prompt token, or sample / retire
            for g in range(slots):
                rid = slot_req[g]
                if rid is None:
                    continue
                req = requests[rid]
                slot_pos[g] += 1
                index[g] += 1
                if slot_pos[g] < len(req.prompt):
                    tok[g, 0] = int(req.prompt[slot_pos[g]])
                    continue
                emitted = outputs[rid]
                if greedy is not None:
                    t = greedy[g]
                else:
                    gen = _request_generator(seed, rid, len(emitted), dev)
                    t = int(sample(logits[g:g + 1], gen, temperature)[0])
                emitted.append(t)
                tok[g, 0] = t
                if len(emitted) >= req.steps:
                    slot_req[g] = None
                    slot_span[g].__exit__(None, None, None)
                    slot_span[g] = None
                    _REQUESTS_DONE.inc()
    finally:
        if executor is not None:
            executor.active_mask = None
            cm.set_linear_hook(prev_hook)
        for sp in slot_span:
            if sp is not None:
                sp.__exit__(None, None, None)
    if stats is not None:
        stats["steps"] = step
        stats["slot_steps"] = slot_steps
        stats["occupancy"] = slot_steps / (step * slots) if step else 0.0
    return [np.asarray(o, np.int32) for o in outputs]
