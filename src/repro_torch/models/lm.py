"""LM assembly: layers -> a stack -> the full model.

The port of `repro.models.lm`: a layer is a (mixer, ffn) pair, the mixer
``global``, ``local`` or ``bidir`` attention, ``cross_global`` (causal
self-attention, then cross-attention over the encoder's output),
``mlstm``, ``slstm``, ``rglru`` or, in the port alone, ``mla`` (latent
attention, `models.mla`), and the ffn ``mlp``, ``moe``,
``moe_dense`` (an MoE plus a dense MLP beside it) or ``none``.  An
`MLAConfig` gives its ``mlp`` layers their own width and its ``moe``
layers ``ffn_shared``, the shared experts run beside the MoE.  The JAX
package stacks homogeneous layer groups under `lax.scan`; here a stack
is a plain `nn.ModuleList` in layer order, layer j of kind
``pattern[j % len(pattern)]`` (groups first, then the remainder layers,
as the JAX stack applies them), and `scan_layers` has no meaning.
``cfg.remat`` does what it does in the JAX package, where it wraps each
layer group in `jax.checkpoint` with nothing saved: where a gradient is
taken, each layer runs under `torch.utils.checkpoint` and its
activations are recomputed in the backward pass; the numbers do not
change.  An encoder-decoder (``family == "encdec"``) has a second stack,
``enc_stack`` of ``cfg.enc_layers`` layers of ``cfg.enc_pattern``, and
its norm ``enc_nf``.

Decode threads one state dict per layer through the stack (a KV cache
for attention, the recurrent state otherwise); the states are updated in
place.  On a CUDA device `capture_decode_step` records one step as a CUDA
graph, which `decode_step(..., graph=)` replays.

The spec functions (`layer_specs`, `stack_specs`, `specs`,
`layer_state_specs`, `stack_state_specs`, `decode_state_specs`) give
each leaf's logical axes, as the JAX ones do (`parallel.sharding` maps
them to a mesh).  `specs` is keyed by the port's state-dict names, the
layout `repro_torch.convert` documents, and `decode_state_specs` mirrors
`decode_state_init` (one dict a layer).  The port stores every layer
apart, so the stacked layout's leading ``"layers"`` axis has no leaf and
is dropped; its rule is None (replicated), so dropping it changes no
placement.

Params are created without gradients, so serving builds no autograd
graph; `trainable` turns gradients on for a model that is to be trained
(`repro_torch.train.step` does), and `loss_fn` is the training loss.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..kernels import launch_count
from ..parallel import sharding as shd
from ..parallel.sharding import constrain
from . import attention as attn
from . import common as cm
from . import ffn as ffn_mod
from . import mla
from . import recurrent as rec
from .common import Config

_ATTENTION = ("global", "local", "bidir")
_CACHED = ("global", "local", "cross_global")     # decode keeps a KV cache

State = List[Dict[str, torch.Tensor]]


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------

_MIXER_PARAMS = {"global": attn.Attention, "local": attn.Attention,
                 "bidir": attn.Attention, "cross_global": attn.Attention,
                 "mlstm": rec.MLSTM, "slstm": rec.SLSTM, "rglru": rec.RGLRU,
                 "mla": mla.MLA}
FFNS = ("mlp", "moe", "moe_dense", "none")


class Layer(nn.Module):
    """One (mixer, ffn) layer (the JAX `layer_init`): a ``cross_global``
    layer also has ``cross`` (its cross-attention) and ``nc`` (the norm
    ahead of it); a layer whose ffn is ``none`` has no ``n2`` and no
    ``ffn``; ``moe_dense`` has ``ffn`` (the MoE) and ``ffn_dense`` (a
    packed MLP); a ``moe`` layer of a config with shared experts also
    has ``ffn_shared`` (a packed MLP of their summed width).  An unknown
    kind raises ValueError."""

    def __init__(self, cfg: Config, generator: torch.Generator, dev,
                 kinds: Tuple[str, str]):
        super().__init__()
        self.kinds = tuple(kinds)
        mixer, f = self.kinds
        if mixer not in _MIXER_PARAMS:
            raise ValueError(f"unknown mixer kind {mixer!r}")
        if f not in FFNS:
            raise ValueError(f"unknown ffn kind {f!r}")
        self.n1 = cm.RMSNorm(cfg.d_model, dev)
        self.mix = _MIXER_PARAMS[mixer](cfg, generator, dev)
        if mixer == "cross_global":
            self.cross = attn.Attention(cfg, generator, dev)
            self.nc = cm.RMSNorm(cfg.d_model, dev)
        if f != "none":
            self.n2 = cm.RMSNorm(cfg.d_model, dev)
        if f == "mlp":
            self.ffn = ffn_mod.MLP(cfg, generator, dev, d_ff=cfg.dense_width)
        elif f in ("moe", "moe_dense"):
            self.ffn = ffn_mod.MoE(cfg, generator, dev)
        if f == "moe" and cfg.shared_width:
            self.ffn_shared = ffn_mod.MLP(cfg, generator, dev,
                                          d_ff=cfg.shared_width)
        if f == "moe_dense":
            self.ffn_dense = ffn_mod.MLP(cfg, generator, dev)


def layer_specs(cfg: Config, kinds: Tuple[str, str]) -> dict:
    """Logical axes of one `Layer`'s leaves, nested as its modules."""
    mixer, f = kinds
    s: dict = {"n1": {"g": (None,)}}
    if mixer in _ATTENTION:
        s["mix"] = attn.specs(cfg)
    elif mixer == "cross_global":
        s["mix"] = attn.specs(cfg)
        s["cross"] = attn.specs(cfg)
        s["nc"] = {"g": (None,)}
    elif mixer == "mlstm":
        s["mix"] = rec.mlstm_specs(cfg)
    elif mixer == "slstm":
        s["mix"] = rec.slstm_specs(cfg)
    elif mixer == "rglru":
        s["mix"] = rec.rglru_specs(cfg)
    elif mixer == "mla":
        s["mix"] = mla.specs(cfg)
    if f != "none":
        s["n2"] = {"g": (None,)}
    if f == "mlp":
        s["ffn"] = ffn_mod.mlp_specs(cfg)
    elif f == "moe":
        s["ffn"] = ffn_mod.moe_specs(cfg)
        if cfg.shared_width:
            s["ffn_shared"] = ffn_mod.mlp_specs(cfg)
    elif f == "moe_dense":
        s["ffn"] = ffn_mod.moe_specs(cfg)
        s["ffn_dense"] = ffn_mod.mlp_specs(cfg)
    return s


def _ffn_block(p: Layer, x, cfg: Config):
    """x plus the layer's ffn of norm(x), and the MoE's aux loss (None
    for a layer without an MoE).  Shared experts run beside `moe_apply`,
    not inside it, so that its call is the routed experts alone."""
    f = p.kinds[1]
    if f == "none":
        return x, None
    h = cm.rmsnorm(p.n2, x, cfg.norm_eps)
    if f == "mlp":
        return x + ffn_mod.mlp_apply(p.ffn, h, cfg), None
    y, aux = ffn_mod.moe_apply(p.ffn, h, cfg)
    if f == "moe_dense":
        y = y + ffn_mod.mlp_apply(p.ffn_dense, h, cfg)
    elif cfg.shared_width:
        y = y + ffn_mod.mlp_apply(p.ffn_shared, h, cfg)
    return x + y, aux


def layer_apply(p: Layer, x, cfg: Config, *, ctx=None, prefix_len: int = 0):
    """One layer over a whole sequence: returns (x, aux), aux None where
    the layer has no MoE."""
    mixer = p.kinds[0]
    h = cm.rmsnorm(p.n1, x, cfg.norm_eps)
    if mixer in _ATTENTION:
        y = attn.apply(p.mix, h, cfg, kind=mixer, prefix_len=prefix_len)
    elif mixer == "cross_global":
        x = x + attn.apply(p.mix, h, cfg, kind="global")
        hc = cm.rmsnorm(p.nc, x, cfg.norm_eps)
        y = attn.apply_cross(p.cross, hc, ctx, cfg)
    elif mixer == "mlstm":
        y = rec.mlstm_apply(p.mix, h, cfg)
    elif mixer == "slstm":
        y = rec.slstm_apply(p.mix, h, cfg)
    elif mixer == "mla":
        y = mla.apply(p.mix, h, cfg)
    else:
        y = rec.rglru_apply(p.mix, h, cfg)
    x = constrain(x + y, ("batch", "seq", "embed"))
    return _ffn_block(p, x, cfg)


def _layer_run(p: Layer, x, cfg: Config, *, ctx=None, prefix_len: int = 0):
    """`layer_apply`, recomputed in the backward pass (``cfg.remat``)
    where a gradient is taken through the layer.  The forward draws no
    random numbers, so the RNG state is not kept; an MoE layer's
    recomputation routes as its first pass did (routing is a function of
    the layer's input alone)."""
    if cfg.remat and torch.is_grad_enabled() and (
            x.requires_grad or p.n1.g.requires_grad):
        return ckpt.checkpoint(layer_apply, p, x, cfg, ctx=ctx,
                               prefix_len=prefix_len, use_reentrant=False,
                               preserve_rng_state=False)
    return layer_apply(p, x, cfg, ctx=ctx, prefix_len=prefix_len)


def layer_state_init(cfg: Config, batch: int, max_len: int, kinds,
                     dev) -> Dict[str, torch.Tensor]:
    mixer = kinds[0]
    if mixer in _CACHED:
        return attn.init_cache(cfg, batch, max_len, dev,
                               kind="local" if mixer == "local" else "global")
    if mixer == "mlstm":
        return rec.mlstm_state_init(cfg, batch, dev)
    if mixer == "slstm":
        return rec.slstm_state_init(cfg, batch, dev)
    if mixer == "rglru":
        return rec.rglru_state_init(cfg, batch, dev)
    if mixer == "mla":
        return mla.init_cache(cfg, batch, max_len, dev)
    raise ValueError(f"no decode state for mixer kind {mixer!r}")


def layer_state_specs(cfg: Config, kinds) -> Dict[str, tuple]:
    mixer = kinds[0]
    if mixer in _CACHED:
        return attn.cache_specs("local" if mixer == "local" else "global")
    if mixer == "mlstm":
        return rec.mlstm_state_specs()
    if mixer == "slstm":
        return rec.slstm_state_specs()
    if mixer == "rglru":
        return rec.rglru_state_specs()
    if mixer == "mla":
        return mla.cache_specs()
    raise ValueError(f"no decode state for mixer kind {mixer!r}")


def layer_decode(p: Layer, x, state, index, cfg: Config, *, ctx=None):
    """One layer, one token: a ``cross_global`` layer attends over its
    own KV cache, then recomputes cross-attention from `ctx`."""
    mixer = p.kinds[0]
    h = cm.rmsnorm(p.n1, x, cfg.norm_eps)
    if mixer in ("global", "local"):
        y, state = attn.decode_step(p.mix, h, state, index, cfg, kind=mixer)
    elif mixer == "cross_global":
        y, state = attn.decode_step(p.mix, h, state, index, cfg,
                                    kind="global")
        x = x + y
        hc = cm.rmsnorm(p.nc, x, cfg.norm_eps)
        y = attn.apply_cross(p.cross, hc, ctx, cfg)
    elif mixer == "mlstm":
        y, state = rec.mlstm_decode(p.mix, h, state, cfg)
    elif mixer == "slstm":
        y, state = rec.slstm_apply(p.mix, h, cfg, state=state,
                                   return_state=True)
    elif mixer == "rglru":
        y, state = rec.rglru_decode(p.mix, h, state, cfg)
    elif mixer == "mla":
        y, state = mla.decode_step(p.mix, h, state, index, cfg)
    else:
        raise ValueError(f"mixer kind {mixer!r} does not decode")
    x, _ = _ffn_block(p, x + y, cfg)
    return x, state


# ---------------------------------------------------------------------------
# stacks: one entry a layer, in the order they apply
# ---------------------------------------------------------------------------

def stack_specs(cfg: Config, n_layers: Optional[int] = None,
                pattern=None) -> List[dict]:
    """`layer_specs` of every layer of a stack (default: the decoder's),
    in the order of `nn.ModuleList` ``stack``; no ``"layers"`` axis."""
    return [layer_specs(cfg, kinds)
            for kinds in cfg.layer_kinds(n_layers or None, pattern)]


def stack_state_specs(cfg: Config, n_layers: Optional[int] = None,
                      pattern=None) -> List[Dict[str, tuple]]:
    return [layer_state_specs(cfg, kinds)
            for kinds in cfg.layer_kinds(n_layers or None, pattern)]


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """Embedding, layer stack, final norm and, where the embeddings are not
    tied, the output ``head``; for an encoder-decoder also ``enc_stack``
    and ``enc_nf`` (the JAX `lm.init` params).  `forward`, `encode` and
    `decode_step` below run it."""

    def __init__(self, cfg: Config, generator: torch.Generator, dev):
        super().__init__()
        self.cfg = cfg
        self.embed = cm.embed_init(generator, cfg, dev)
        self.stack = nn.ModuleList(
            [Layer(cfg, generator, dev, kinds) for kinds in cfg.layer_kinds()])
        self.nf = cm.RMSNorm(cfg.d_model, dev)
        if not cfg.tie_embeddings:
            # never packed (as in the JAX package): a plain product
            self.head = cm._init_dense(generator, cfg.d_model, cfg.vocab,
                                       cfg, False, dev)
        if cfg.family == "encdec":
            self.enc_stack = nn.ModuleList(
                [Layer(cfg, generator, dev, kinds) for kinds in
                 cfg.layer_kinds(cfg.enc_layers, cfg.enc_pattern)])
            self.enc_nf = cm.RMSNorm(cfg.d_model, dev)

    @property
    def device(self) -> torch.device:
        return self.embed["e"].device


def init(generator: torch.Generator, cfg: Config, device="cuda") -> LM:
    """Random params from `generator`, which must live on `device`."""
    dev = cm.device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    return LM(cfg, generator, dev)


def _flat(tree: dict, prefix: str) -> Dict[str, tuple]:
    out = {}
    for k, v in (enumerate(tree) if isinstance(tree, list)
                 else tree.items()):
        name = f"{prefix}.{k}"
        out.update({name: v} if isinstance(v, tuple) else _flat(v, name))
    return out


def specs(cfg: Config) -> Dict[str, tuple]:
    """Logical axes of every param and buffer of `LM`, keyed by its
    state-dict name (``embed.e``, ``stack.<j>.mix.wq.packed``, ``nf.g``,
    ``head.w``, ``enc_stack.<j>....``, ``enc_nf.g``)."""
    s = {**_flat(cm.embed_specs(), "embed"),
         **_flat(stack_specs(cfg), "stack"), "nf.g": (None,)}
    if not cfg.tie_embeddings:
        s.update(_flat(cm._dense_specs("embed", "vocab", cfg, False),
                       "head"))
    if cfg.family == "encdec":
        s.update(_flat(stack_specs(cfg, cfg.enc_layers, cfg.enc_pattern),
                       "enc_stack"))
        s["enc_nf.g"] = (None,)
    return s


def trainable(params: LM) -> Dict[str, nn.Parameter]:
    """Turn gradients on for every param of the model and return them by
    state-dict name, in state-dict order.  Packed bit-planes are integer
    buffers, not params, and cannot be trained (nor can the JAX
    package's, whose `value_and_grad` refuses uint32): a model holding
    any raises ValueError naming them."""
    packed = [name for name, m in params.named_modules()
              if isinstance(m, cm.PackedLinear) and m.packed is not None]
    if packed:
        raise ValueError(
            f"{params.cfg.name}: {len(packed)} packed projections cannot "
            f"be trained ({', '.join(packed[:3])}, ...); train the model "
            "with quant_bits=None")
    out = {}
    for name, p in params.named_parameters():
        out[name] = p.requires_grad_(True)
    return out


def _embed_tokens(params: LM, tokens, cfg: Config):
    e = params.embed["e"]
    # sqrt(d_model) is rounded to the embedding dtype first, as in the JAX
    # code: in bf16, sqrt(960) becomes 31.0
    s = float(torch.tensor(math.sqrt(cfg.d_model),
                           dtype=torch.float32).to(e.dtype))
    # a row gather whose backward sums in a fixed order on the CPU too
    # (indexing's backward, an accumulating index_put, does not there)
    return (shd.embedding(tokens, e) * s).to(cfg.adtype)


def packed_projections(params: LM, encoder: bool = False) -> int:
    """The model's packed projections, each one bit-plane kernel launch
    where a call runs it.  By default those outside the encoder: the
    launches of one decode call, or of a forward's decoder.  With
    `encoder`, those of ``enc_stack``: the launches of one `encode`,
    which `forward` and `serve.engine.generate` run once a call, not at
    every step (Whisper-small: 132 and 84; 0 without an encoder)."""
    return sum(1 for name, m in params.named_modules()
               if isinstance(m, cm.PackedLinear) and m.packed is not None
               and name.startswith("enc_stack.") == encoder)


def _logits(params: LM, x, cfg: Config):
    xf = cm.rmsnorm(params.nf, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = xf.to(torch.float32) @ \
            params.embed["e"].to(torch.float32).T
    else:
        logits = cm.linear(params.head, xf).to(torch.float32)
    logits = constrain(logits, ("batch", "seq", "vocab"))
    return cm.softcap(logits, cfg.final_softcap)


def encode(params: LM, enc_inputs) -> torch.Tensor:
    """The encoder pass: frame or patch embeddings [B, T, D] (a tensor or
    an array) -> the context [B, T, D] on the model's device that
    cross-attention reads (its aux is dropped, as in the JAX
    function)."""
    cfg = params.cfg
    if enc_inputs is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: it needs "
                         "enc_inputs")
    h = torch.as_tensor(enc_inputs, device=params.device).to(cfg.adtype)
    for layer in params.enc_stack:
        h, _ = _layer_run(layer, h, cfg)
    return cm.rmsnorm(params.enc_nf, h, cfg.norm_eps)


def forward(params: LM, tokens, *, enc_inputs=None, prefix_embeddings=None,
            last_only: bool = False):
    """(logits, aux) for tokens [B, S]: logits [B, S, V], or [B, 1, V]
    with `last_only`; aux the f32 sum of the MoE layers' load-balancing
    losses (0 without an MoE).

    `enc_inputs` [B, T, D] feed an encoder-decoder's encoder;
    `prefix_embeddings` [B, P, D] are put ahead of the token embeddings
    and their positions sliced off the output, and with ``cfg.prefix_lm``
    attention over them is bidirectional.
    """
    cfg = params.cfg
    x = _embed_tokens(params, tokens, cfg)
    prefix_len = 0
    ctx = None
    if prefix_embeddings is not None:
        x = torch.cat([prefix_embeddings.to(x.dtype), x], dim=1)
        prefix_len = prefix_embeddings.shape[1]
    if cfg.family == "encdec":
        ctx = encode(params, enc_inputs)
    x = constrain(x, ("batch", "seq", "embed"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params.stack:
        x, a = _layer_run(layer, x, cfg, ctx=ctx,
                          prefix_len=prefix_len if cfg.prefix_lm else 0)
        if a is not None:
            aux = aux + a
    if prefix_len:
        x = x[:, prefix_len:]
    if last_only:
        x = x[:, -1:]
    return _logits(params, x, cfg), aux


def loss_fn(params: LM, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01):
    """Mean next-token cross entropy plus ``aux_weight`` times the MoE
    aux loss: returns (loss, {"nll", "aux"}), f32 scalars.

    `batch` holds ``tokens`` and ``labels`` [B, S] (a label below 0 is
    not counted: the data pipeline puts -1 at the last position of every
    row) and, where the model takes them, ``enc_inputs`` or
    ``prefix_embeddings``.  `torch.gather` refuses the index -1 that
    JAX's `take_along_axis` takes, so labels are clamped to 0 first and
    the mask zeroes those terms and their gradient.
    """
    logits, aux = forward(
        params, batch["tokens"], enc_inputs=batch.get("enc_inputs"),
        prefix_embeddings=batch.get("prefix_embeddings"))
    labels = batch["labels"]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1,
                      labels.clamp(min=0).to(torch.long)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    nll = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def decode_state_init(cfg: Config, batch: int, max_len: int,
                      device="cuda") -> State:
    dev = cm.device(device)
    return [layer_state_init(cfg, batch, max_len, kinds, dev)
            for kinds in cfg.layer_kinds()]


def decode_state_specs(cfg: Config) -> List[Dict[str, tuple]]:
    """Logical axes of `decode_state_init`'s states, one dict a layer."""
    return stack_state_specs(cfg)


def _decode(params: LM, token, states: State, index, ctx=None):
    """The eager decode step: each kernel launched from Python."""
    cfg = params.cfg
    if cfg.family == "encdec" and ctx is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: decode_step "
                         "needs ctx from encode")
    x = _embed_tokens(params, token, cfg)
    index = attn.positions(index, x.shape[0], x.device)
    for layer, state in zip(params.stack, states):
        x, _ = layer_decode(layer, x, state, index, cfg, ctx=ctx)
    return _logits(params, x, cfg), states


def decode_step(params: LM, token, states: State, index, *,
                ctx: Optional[torch.Tensor] = None,
                graph: Optional[DecodeGraph] = None):
    """One decode step: token [B, 1] -> (logits [B, 1, V], states).

    `index` is a scalar or a [B] vector of positions; `states` is
    updated in place and returned (placed states: each layer's dict
    takes its new tensors).  An encoder-decoder takes `ctx`, the
    output of `encode`.

    With `graph` (from `capture_decode_step` on these params and
    states), the step is that graph replayed: the token and positions
    are copied into its buffers without blocking (see `DecodeGraph`),
    and the logits come back as a fresh tensor.  The kernels and the
    numbers are the eager step's; the packed-linear hook is host-side
    and does not fire in a replay.
    """
    if graph is None:
        return _decode(params, token, states, index, ctx=ctx)
    if ctx is not None:
        raise ValueError("a captured decode step takes no ctx")
    return graph.replay(params, token, states, index), states


class DecodeGraph:
    """One decode step captured as a CUDA graph (`capture_decode_step`):
    the graph, the static token [B, 1] and position [B] buffers it reads,
    the logits it writes, the states it updates in place and the kernel
    launches one replay makes (`launches`, {kernel name: launches}).

    A replay copies the token and positions into the graph's buffers
    with ``non_blocking=True`` and records `staged` once those copies are
    queued: a caller that writes a pinned host token or index again
    before it has read the step's result waits on `staged` first.  Each
    replay counts its launches (`kernels.launch_count`), as the eager
    step's wrappers would; the capture counts those of its warm-up step
    (run eagerly, on copies of the states) and none for the recording,
    which launches nothing."""

    def __init__(self, params: LM, token, states: State, index):
        dev = params.device
        if dev.type != "cuda":
            raise ValueError(f"a decode step is captured on a CUDA device, "
                             f"not {dev}")
        self.owner = weakref.ref(params)
        self.states = states
        self.token = torch.empty(tuple(token.shape), dtype=torch.long,
                                 device=dev)
        self.token.copy_(token)
        self.pos = attn.positions(index, token.shape[0], dev).clone()
        self.staged = torch.cuda.Event()
        prev = cm.set_linear_hook(None)
        try:
            # warm up on copies of the states, on a side stream: builds
            # the kernels and fills the lazy caches, and leaves the states
            # as they were (a recurrent update must not run twice)
            warm = [{k: v.clone() for k, v in st.items()} for st in states]
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                _decode(params, self.token, warm, self.pos)
            torch.cuda.current_stream(dev).wait_stream(side)
            del warm
            self.graph = torch.cuda.CUDAGraph()
            with launch_count.recording() as self.launches, \
                    torch.cuda.graph(self.graph):
                self.logits, _ = _decode(params, self.token, states,
                                         self.pos)
        finally:
            cm.set_linear_hook(prev)

    def replay(self, params: LM, token, states: State, index
               ) -> torch.Tensor:
        if self.owner() is not params:
            raise ValueError("the decode step was captured on other params")
        if states is not self.states and [
                t.data_ptr() for st in states for t in st.values()] != [
                t.data_ptr() for st in self.states for t in st.values()]:
            raise ValueError("the decode step was captured on other states")
        self.token.copy_(token, non_blocking=True)
        if isinstance(index, torch.Tensor):
            self.pos.copy_(index.expand(self.pos.shape[0]),
                           non_blocking=True)
        else:
            self.pos.fill_(int(index))
        self.staged.record()
        self.graph.replay()
        launch_count.add(self.launches)
        return self.logits.clone()


def capture_decode_step(params: LM, token, states: State, index
                        ) -> DecodeGraph:
    """`decode_step` on `states` (batch B, updated in place at every
    replay) captured as one CUDA graph, for ``decode_step(..., graph=)``.
    `token` [B, 1] and `index` (a scalar or [B]) give the buffers' shapes
    and first values; the states are left as they were.  A step that
    cannot be captured raises; there is no eager fallback."""
    return DecodeGraph(params, token, states, index)
