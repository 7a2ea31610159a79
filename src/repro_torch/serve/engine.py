"""Serving: prefill, batched decode and continuous batching.

The port of `repro.serve.engine`.  With cfg.quant_bits set, every
projection streams w-bit packed bit-plane weights through the bit-plane
kernel - the decode step is memory-bound, so weight bytes are the term
this feature attacks.

Sampling at temperature > 0 draws from an explicit `torch.Generator`; it
cannot reproduce `jax.random`, so only greedy tokens are comparable with
the JAX package.

`make_jitted_serve_step` is the compiled decode step: on a mesh of many
ranks it runs on params and states placed by their specs (`DTensor`s);
on one card it is one step captured as a CUDA graph and replayed.
`serve_continuous` replays such a graph at every step on a CUDA device
(`lm.capture_decode_step`).
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..models import common as cm
from ..models import lm
from ..parallel import sharding as shd
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

_REQUESTS_DONE = obs_metrics.counter("serve.requests_completed")
_DECODE_STEPS = obs_metrics.counter("serve.decode_steps")
_GRAPH_CAPTURES = obs_metrics.counter("serve.graph_captures")


def prefill(params: lm.LM, tokens: torch.Tensor, max_len: int, *,
            enc_inputs=None):
    """Process the prompt; returns (last-token logits, fresh decode state).

    As in the JAX package, the state comes back freshly initialised:
    `generate` primes the caches by replaying the prompt through decode.
    An encoder-decoder takes `enc_inputs` [B, T, D].
    """
    b, s = tokens.shape
    with obs_trace.span("serve.prefill", batch=b, seq=s,
                        family=params.cfg.family):
        logits, _ = lm.forward(params, tokens, enc_inputs=enc_inputs)
        states = lm.decode_state_init(params.cfg, b, max_len, params.device)
    return logits[:, -1:], states


def decode_step(params: lm.LM, token, states, index, *, ctx=None):
    return lm.decode_step(params, token, states, index, ctx=ctx)


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
             enc_inputs=None, executor=None) -> torch.Tensor:
    """Greedy/temperature generation; returns tokens [B, steps] int32.

    An encoder-decoder encodes `enc_inputs` [B, T, D] once, and every
    step reads that context.  The prompt is replayed through the decode
    path to prime the caches, then `steps` tokens are sampled.
    ``executor`` is installed as the packed-linear hook for the duration
    of the call (see
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
    ctx = lm.encode(params, enc_inputs) if params.cfg.family == "encdec" \
        else None
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
                        params, prompt[:, t:t + 1], states, t, ctx=ctx)
        out = []
        tok = sample(logits, generator)
        for t in range(steps):
            out.append(tok)
            with obs_trace.span("serve.decode_step", step=t):
                logits, states = lm.decode_step(params, tok[:, None],
                                                states, s + t, ctx=ctx)
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
    the port keeps its batch on axis 0.  KV caches would clean themselves
    through the validity mask, but recurrent states carry forward (and
    some start away from zero: mLSTM's m at -1e30, sLSTM's at -10), so
    every kind is restored alike."""
    for layer, init in zip(states, fresh):
        for name, t in layer.items():
            t[slot].copy_(init[name][0])


def _capture(params: lm.LM, token, states, index) -> lm.DecodeGraph:
    _GRAPH_CAPTURES.inc()
    return lm.capture_decode_step(params, token, states, index)


class _ServeGraph:
    """What `serve_continuous` keeps on one card for one (slots, max_len)
    between its calls: the batch's decode states, a batch-1 fresh init
    for the row resets, pinned host buffers for the tokens [slots, 1] and
    positions [slots], and the decode step on them captured as one CUDA
    graph."""

    def __init__(self, params: lm.LM, slots: int, max_len: int):
        dev = params.device
        self.ptr = params.embed["e"].data_ptr()
        self.states = lm.decode_state_init(params.cfg, slots, max_len, dev)
        self.fresh = lm.decode_state_init(params.cfg, 1, max_len, dev)
        self.tok = torch.zeros((slots, 1), dtype=torch.long,
                               pin_memory=True)
        self.index = torch.zeros((slots,), dtype=torch.long,
                                 pin_memory=True)
        self.graph = _capture(params, self.tok, self.states, self.index)
        self.busy = False


# each params' `_ServeGraph`s by (slots, max_len); an entry goes with its
# params (a graph holds them only by a weak reference), and a copy of the
# params starts with none
_SERVE_GRAPHS = weakref.WeakKeyDictionary()


def _step_graph(params: lm.LM, slots: int, max_len: int,
                executor) -> Optional[_ServeGraph]:
    """The captured step `serve_continuous` replays, or None where it
    runs the eager step: on a device other than CUDA, and with an
    `executor` installed (its hook runs on the host at every projection,
    and a replay would skip it).  Kept for as long as the params live,
    keyed by (slots, max_len), made at the first call; one captured on
    params that have moved since is made again."""
    if params.device.type != "cuda" or executor is not None:
        return None
    cache = _SERVE_GRAPHS.setdefault(params, {})
    entry = cache.get((slots, max_len))
    if entry is None or entry.ptr != params.embed["e"].data_ptr():
        entry = cache[(slots, max_len)] = _ServeGraph(params, slots,
                                                      max_len)
    return entry


def serve_continuous(params: lm.LM, requests: List[Request], *,
                     slots: int, max_len: int, temperature: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     executor=None,
                     stats: Optional[Dict] = None) -> List[np.ndarray]:
    """Token-level continuous batching over a fixed-width decode batch.

    Every step runs ONE batched decode over all `slots` rows at per-row
    sequence positions (the vector-`index` decode path), one call of
    `lm.decode_step`; between steps, finished requests retire and queued
    requests take the freed rows.  A newly admitted request replays its
    prompt token by token in its row while other rows keep decoding.

    On a CUDA device with no `executor`, that call replays one CUDA
    graph of the step: the first call for a (slots, max_len) captures
    it, on decode states it keeps with the graph for as long as the
    params live, and later calls replay it on those states.  They need no reset between calls:
    each row's state is restored at its admission, as within a call.
    The tokens and positions are staged in pinned host buffers and
    copied without blocking.  On the CPU, and with an `executor`, every
    call runs the eager step on states of its own.  Each step counts
    in ``serve.decode_steps`` (``mode="graph"`` or ``"eager"``), each
    capture in ``serve.graph_captures``.  A call that re-enters while
    another on the same params, slots and max_len is running raises
    RuntimeError.

    At temperature > 0, emission n of request r draws from a generator
    seeded by (seed, r, n), where seed is ``generator.initial_seed()``
    (0 without one), so a request's tokens do not depend on what it was
    batched with.

    Returns the emitted tokens per request, in submission order.  A
    ``stats`` dict receives ``steps`` (batched dispatches),
    ``occupancy`` (mean live-row fraction) and ``slot_steps``.

    With the tracer on, each step records four wall spans, in this order
    and without overlap, each with ``step`` (1-based, that of its
    ``serve.batch_step``): ``serve.admit`` (the rows filled from the
    queue and their state reset; ``admitted``, ``queued``),
    ``serve.batch_step`` (staging the tokens and positions, and the
    decode call, which launches the step's kernels or replays its graph;
    ``live``), ``serve.readback`` (the greedy tokens copied to the host,
    where the host waits for the device to finish the step) and
    ``serve.advance`` (each row's next prompt token, emission or
    retirement; ``emitted``, ``retired``).  At temperature > 0
    ``serve.readback`` holds no more than the wait for a replay's staging
    copies: the wait for the step falls in the first row sampled, inside
    ``serve.advance``.  Each request is an `obs.trace.async_span`
    ``serve.request``, keyed by its index, from its admission to its
    retirement.

    An encoder-decoder is refused (NotImplementedError): a request would
    need its own encoder context, which the JAX function does not pass
    either.
    """
    if params.cfg.family == "encdec":
        raise NotImplementedError(
            f"{params.cfg.name}: serve_continuous runs decoder-only models;"
            " an encoder-decoder needs a context per request (use "
            "generate with enc_inputs)")
    for i, r in enumerate(requests):
        if len(r.prompt) == 0:
            raise ValueError(f"request {i} has an empty prompt")
        if len(r.prompt) + r.steps > max_len:
            raise ValueError(f"request {i} needs {len(r.prompt) + r.steps}"
                             f" positions, max_len is {max_len}")
    dev = params.device
    seed = generator.initial_seed() if generator is not None else 0
    captured = _step_graph(params, slots, max_len, executor)
    if captured is None:
        mode = "eager"
        states = lm.decode_state_init(params.cfg, slots, max_len, dev)
        fresh = lm.decode_state_init(params.cfg, 1, max_len, dev)
        tok = np.zeros((slots, 1), np.int64)
        index = np.zeros((slots,), np.int64)
    else:
        if captured.busy:
            raise RuntimeError(
                f"serve_continuous re-entered while a call on the same "
                f"params with slots={slots}, max_len={max_len} runs")
        mode, states, fresh = "graph", captured.states, captured.fresh
        # views of the pinned buffers the replay copies from; the last
        # call's copies are done (its last step was read back)
        tok, index = captured.tok.numpy(), captured.index.numpy()
        tok[:], index[:] = 0, 0
        captured.busy = True
    queue = deque(enumerate(requests))
    outputs: List[Optional[List[int]]] = [None] * len(requests)
    slot_req = [None] * slots        # request id per row, None = idle
    slot_pos = [0] * slots           # prompt tokens consumed per row
    slot_span = [None] * slots       # open serve.request span per row
    step = slot_steps = 0
    prev_hook = cm.set_linear_hook(executor) if executor is not None \
        else None
    try:
        while queue or any(r is not None for r in slot_req):
            step += 1
            with obs_trace.span("serve.admit", step=step) as sp:
                # fill every idle row from the queue
                admitted = 0
                for g in range(slots):
                    if slot_req[g] is not None or not queue:
                        continue
                    rid, req = queue.popleft()
                    _reset_state_slot(states, fresh, g)
                    slot_req[g], slot_pos[g], index[g] = rid, 0, 0
                    outputs[rid] = []
                    tok[g, 0] = int(req.prompt[0])
                    slot_span[g] = obs_trace.async_span(
                        "serve.request", rid, request=rid, slot=g,
                        prompt=len(req.prompt), steps=req.steps)
                    slot_span[g].__enter__()
                    admitted += 1
                live = np.array([r is not None for r in slot_req])
                if executor is not None:
                    executor.active_mask = live
                slot_steps += int(live.sum())
                sp.set(admitted=admitted, queued=len(queue))
            with obs_trace.span("serve.batch_step", step=step,
                                live=int(live.sum())):
                if captured is None:
                    logits, states = lm.decode_step(
                        params, torch.as_tensor(tok, device=dev), states,
                        torch.as_tensor(index, device=dev))
                else:
                    logits, states = lm.decode_step(
                        params, captured.tok, states, captured.index,
                        graph=captured.graph)
                _DECODE_STEPS.inc(mode=mode)
            with obs_trace.span("serve.readback", step=step):
                # the step's one host sync; it follows the replay's copies
                # of tok and index on the stream, so the writes to them
                # below come after those copies.  At temperature > 0
                # nothing is read back before the first write: wait for
                # the copies alone
                if temperature == 0.0:
                    greedy = torch.argmax(logits[:, -1], dim=-1).tolist()
                else:
                    greedy = None
                    if captured is not None:
                        captured.graph.staged.synchronize()
            with obs_trace.span("serve.advance", step=step) as sp:
                # per row: next prompt token, or sample / retire
                n_emitted = n_retired = 0
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
                        gen = _request_generator(seed, rid, len(emitted),
                                                 dev)
                        t = int(sample(logits[g:g + 1], gen,
                                       temperature)[0])
                    emitted.append(t)
                    tok[g, 0] = t
                    n_emitted += 1
                    if len(emitted) >= req.steps:
                        slot_req[g] = None
                        slot_span[g].__exit__(None, None, None)
                        slot_span[g] = None
                        _REQUESTS_DONE.inc()
                        n_retired += 1
                sp.set(emitted=n_emitted, retired=n_retired)
    finally:
        if captured is not None:
            captured.busy = False
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


# ---------------------------------------------------------------------------
# the compiled decode step
# ---------------------------------------------------------------------------

def _check_cfg(params: lm.LM, cfg: cm.Config) -> None:
    if params.cfg != cfg:
        raise ValueError(f"step built for {cfg.name}, called with "
                         f"{params.cfg.name}")


class CapturedServeStep:
    """`fn(params, token, states, index) -> (logits, states)` on one card:
    the decode step captured as a CUDA graph (`lm.capture_decode_step`)
    the first time a set of state storages is seen (with the params, the
    token's shape and the kind of index), then replayed through
    ``lm.decode_step(..., graph=)``, the states updated in place (the
    counterpart of ``donate_argnums``).  A position is copied into the
    graph's own buffer before each replay, so it is not baked in; the
    logits come back as a fresh tensor, and sampling stays outside.  The
    packed-linear hook is host-side and never fires here, as JAX's
    jitted calls never see it.  Each replay counts the kernel launches it
    makes (`kernels.launch_count`), as the wrappers would.
    A capture that fails raises; there is no eager fallback."""

    def __init__(self, cfg: cm.Config):
        self.cfg = cfg
        self.graphs: Dict[tuple, lm.DecodeGraph] = {}
        self._params: Dict[int, lm.LM] = {}     # the graphs read them

    def __call__(self, params: lm.LM, token, states, index):
        _check_cfg(params, self.cfg)
        token = torch.as_tensor(token)
        key = (id(params), params.embed["e"].data_ptr(), tuple(token.shape),
               isinstance(index, torch.Tensor),
               tuple(t.data_ptr() for st in states for t in st.values()))
        graph = self.graphs.get(key)
        if graph is None:
            self._params[id(params)] = params
            graph = self.graphs[key] = _capture(params, token, states, index)
        return lm.decode_step(params, token, states, index, graph=graph)


def _placed_step(mesh, cfg: cm.Config, pspecs, sspecs, tok_spec):
    """The decode step on `DTensor`s over `mesh`: the model's params are
    placed by their specs the first time (in place, as a device put of
    the module), the states at every call (a no-op once placed), and the
    step runs with plain tensors made inside the model taken as
    replicated.  Returns the logits as a plain tensor on every rank."""
    ms = shd.mesh_shape(mesh)

    def fn(params: lm.LM, token, states, index):
        _check_cfg(params, cfg)
        prev = cm.set_linear_hook(None)
        try:
            with implicit_replication():
                if not isinstance(params.embed["e"], DTensor):
                    shd.place_module(params, mesh, shd.shardings_pruned(
                        mesh, pspecs, params.state_dict()))
                where = shd.shardings_pruned(mesh, sspecs, states)
                for st, pl in zip(states, where):
                    for k in st:
                        st[k] = shd.place(st[k], mesh, pl[k])
                token = torch.as_tensor(token, device=params.device)
                tok = shd.place(token, mesh, shd.placements(
                    mesh, shd._prune_spec(tok_spec, tuple(token.shape), ms)))
                logits, states = lm.decode_step(params, tok, states, index)
                return logits.full_tensor(), states
        finally:
            cm.set_linear_hook(prev)
    return fn


def make_jitted_serve_step(mesh, cfg: cm.Config,
                           rules: Optional[dict] = None):
    """The compiled one-token decode step over `mesh` (a
    `torch.distributed` `DeviceMesh`, see `launch.mesh`):
    ``fn(params, token, states, index) -> (logits, states)``.

    On a mesh of many ranks, params and states are placed by
    `lm.specs` / `lm.decode_state_specs` through `shardings_pruned`
    under `rules` (the token by ``("batch", None)``), and the step runs
    on `DTensor`s.  On a one-device CUDA mesh nothing is placed (a
    `DTensor` over one rank adds host dispatch and no collective): the
    step is a `CapturedServeStep`.  On a one-device CPU mesh it is the
    eager `lm.decode_step`.
    """
    shd.set_mesh_axes(mesh.mesh_dim_names)
    shd.set_active_rules(rules)
    if mesh.size() > 1:
        return _placed_step(
            mesh, cfg, shd.tree_specs(lm.specs(cfg), rules),
            shd.tree_specs(lm.decode_state_specs(cfg), rules),
            shd.spec_for(("batch", None), rules))
    if mesh.device_type == "cuda":
        return CapturedServeStep(cfg)

    def eager(params: lm.LM, token, states, index):
        _check_cfg(params, cfg)
        prev = cm.set_linear_hook(None)
        try:
            return lm.decode_step(params, torch.as_tensor(
                token, device=params.device), states, index)
        finally:
            cm.set_linear_hook(prev)
    return eager
