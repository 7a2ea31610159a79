"""Model substrate: config schema, parameter init, primitive layers.

The port of `repro.models.common`.  Parameters live in `nn.Module`s whose
attribute names follow the JAX package's param dicts (``{"w"}`` or
``{"packed", "scale"}`` for a projection, ``{"g"}`` for a norm), so a
state-dict key such as ``stack.0.mix.wq.packed`` names the same array as
the JAX path ``stack/.../mix/wq/packed`` (see `repro_torch.convert`).

The CoMeFa technique enters through `linear()`: with cfg.quant_bits set,
projections store *packed bit-planes* (w bits per weight in device
memory) and contract through the bit-plane kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..kernels import ops as kops
from ..parallel import sharding as shd
from ..quant import bitplane

@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX package's `Config`, field for field.

    ``quant_mode`` is kept for parity and ignored by the port: a packed
    projection on a CUDA tensor always runs the CUDA kernel, and on a CPU
    tensor its plain PyTorch version.
    """
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    pattern: Tuple[Tuple[str, str], ...] = (("global", "mlp"),)
    # attention
    window: int = 4096                     # sliding window for "local"
    rope_theta: float = 10_000.0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qk_norm: bool = False
    prefix_lm: bool = False                # bidirectional prefix (VLM)
    # ffn
    act: str = "silu"
    # moe
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_group: int = 512
    # enc-dec
    family: str = "decoder"                # "decoder" | "encdec"
    enc_layers: int = 0
    enc_pattern: Tuple[Tuple[str, str], ...] = (("bidir", "mlp"),)
    # modality frontend stub: inputs arrive as embeddings, not token ids
    frontend: str = "none"                 # none | audio_stub | vision_stub
    frontend_len: int = 0                  # frames/patches per example
    # recurrent dims
    conv_width: int = 4                    # RG-LRU temporal conv
    lru_width: int = 0                     # 0 -> d_model
    # CoMeFa bit-plane quantization (weight-only)
    quant_bits: Optional[int] = None
    quant_mode: str = "xla"                # kept for parity; ignored here
    # numerics / misc
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    remat: bool = True
    scan_layers: bool = True

    # what `reduced` shrinks besides the fields every config shrinks
    REDUCED: ClassVar[dict] = {}

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    # the FFN's shape, as `MLAConfig` overrides it (properties, so that
    # `dataclasses.asdict` stays the JAX package's)
    @property
    def dense_width(self) -> int:
        """The width of an ``mlp`` layer."""
        return self.d_ff

    @property
    def shared_width(self) -> int:
        """The width of the one gated MLP that holds an MoE layer's
        shared experts, run beside `moe_apply`; 0 where there are none."""
        return 0

    @property
    def renormalise_gates(self) -> bool:
        """Whether the MoE's top-k gates are renormalised to sum to 1."""
        return True

    def layer_kinds(self, n_layers: Optional[int] = None,
                    pattern=None) -> list:
        pattern = pattern or self.pattern
        n = self.n_layers if n_layers is None else n_layers
        return [pattern[i % len(pattern)] for i in range(n)]


@dataclasses.dataclass(frozen=True)
class MLAConfig(Config):
    """The port's fields for multi-head latent attention (the ``mla``
    mixer) and fine-grained experts (DeepSeek-V2 [arXiv:2405.04434]),
    which the JAX package's `Config` does not have.

    Attention: a query of ``qk_nope_dim + qk_rope_dim`` a head, a
    ``kv_lora_rank``-wide latent and a ``qk_rope_dim``-wide RoPE key
    shared by the heads, values of ``v_head_dim``; RoPE scaled by YaRN
    (``yarn_*``, as the source's ``rope_scaling``; a factor of 1 is plain
    RoPE).  FFNs: ``mlp`` layers of width ``d_ff_dense`` (0: ``d_ff``),
    ``n_shared`` always-on experts of width ``d_ff`` beside each MoE, and
    with ``norm_topk`` False the top-k gates left as the router's
    probabilities."""
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    d_ff_dense: int = 0
    n_shared: int = 0
    norm_topk: bool = True
    yarn_factor: float = 1.0
    yarn_original_len: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    # every MLA width, the dense width, and one dense and two MoE layers
    # of 8 experts, top 3, at a capacity that drops nothing (3 x 3 / 8 > 1)
    REDUCED: ClassVar[dict] = dict(
        kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        d_ff_dense=192, n_experts=8, top_k=3, capacity_factor=3.0,
        n_layers=3)

    @property
    def dense_width(self) -> int:
        return self.d_ff_dense or self.d_ff

    @property
    def shared_width(self) -> int:
        return self.n_shared * self.d_ff

    @property
    def renormalise_gates(self) -> bool:
        return self.norm_topk


def reduced(cfg: Config, **overrides) -> Config:
    """Tiny same-family config for CPU smoke tests (an `MLAConfig` also
    shrinks its own widths, `MLAConfig.REDUCED`)."""
    shrink = dict(
        n_layers=max(len(cfg.pattern), 2 if cfg.family == "encdec" else
                     len(cfg.pattern)),
        d_model=64,
        n_heads=4, kv_heads=min(cfg.kv_heads, 2), head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128, vocab=256,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        moe_group=64, window=min(cfg.window, 32),
        enc_layers=min(cfg.enc_layers, 2),
        frontend_len=min(cfg.frontend_len, 8) if cfg.frontend_len else 0,
        lru_width=0, scan_layers=False, remat=False, dtype="float32",
    )
    shrink.update(cfg.REDUCED)
    shrink.update(overrides)
    return dataclasses.replace(cfg, **shrink)


def device(name) -> torch.device:
    """Resolve a device name; asking for CUDA where there is none raises.

    The port never falls back to the CPU on its own: a caller that wants
    the CPU says ``device="cpu"``.
    """
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but "
                           "torch.cuda.is_available() is False")
    return dev


def _normal(generator: torch.Generator, shape, dev) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=dev,
                       dtype=torch.float32)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

class PackedLinear(nn.Module):
    """One projection: dense ``w`` [in, out], or CoMeFa bit-planes
    ``packed`` int32 [bits, in/32, out] with ``scale`` f32 [1, out].

    Which one is held is decided by `_init_dense` (as in the JAX package,
    only ``cfg.quant_bits`` with ``in % 32 == 0`` packs); the absent one
    is None and stays out of the state dict.
    """

    def __init__(self, w: Optional[torch.Tensor] = None,
                 packed: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None):
        super().__init__()
        if (w is None) == (packed is None):
            raise ValueError("give either w or packed + scale")
        self.register_parameter("w", None if w is None else _frozen(w))
        self.register_buffer("packed", packed)
        self.register_buffer("scale", scale)


def _dense_specs(in_axis: Optional[str], out_axis: Optional[str],
                 cfg: Config, quantize: bool) -> dict:
    """Logical axes of one projection's leaves: packed planes
    ``("bits", in, out)`` (K/32 along ``in``) and ``scale`` ``(None,
    out)``, or a dense ``w`` ``(in, out)``."""
    if quantize and cfg.quant_bits:
        return {"packed": ("bits", in_axis, out_axis),
                "scale": (None, out_axis)}
    return {"w": (in_axis, out_axis)}


def _init_dense(generator: torch.Generator, in_dim: int, out_dim: int,
                cfg: Config, quantize: bool, dev) -> PackedLinear:
    std = 1.0 / math.sqrt(in_dim)
    w = _normal(generator, (in_dim, out_dim), dev) * std
    if quantize and cfg.quant_bits and in_dim % 32 == 0:
        packed, scale = bitplane.quantize_pack(w, cfg.quant_bits, axis=0)
        return PackedLinear(packed=packed, scale=scale)
    return PackedLinear(w=w.to(cfg.adtype))


# Host-side interceptor for packed-projection contractions (the JAX
# package's contract, `repro.models.common.set_linear_hook`).  A serving
# executor installs itself here to route packed GEMVs elsewhere.
# Signature: hook(params, x2 [rows, K], bits) -> [rows, N] tensor, or None
# to fall through to the bit-plane kernel; ``params`` is a dict with the
# projection's "packed" and "scale".
_LINEAR_HOOK = None


def set_linear_hook(hook):
    """Install (or clear, with None) the packed-linear hook.

    Returns the previous hook so callers can restore it in a finally
    block - the serving engine scopes the executor to one generate call.
    """
    global _LINEAR_HOOK
    prev = _LINEAR_HOOK
    _LINEAR_HOOK = hook
    return prev


def linear(params: PackedLinear, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W with optional bit-plane packed weights (CoMeFa path).

    The packed branch is one kernel launch: the kernel takes x in its own
    dtype, widens it to f32, sums in f32 and rounds to x's dtype, which is
    what the JAX kernel branch's casts around its f32 kernel give.
    """
    if params.w is not None:
        return shd.contiguous_grad(x @ params.w.to(x.dtype))
    packed, scale = params.packed, params.scale
    bits = packed.shape[0]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _LINEAR_HOOK is not None:
        y = _LINEAR_HOOK({"packed": packed, "scale": scale}, x2, bits)
        if y is not None:
            return y.reshape(*lead, -1).to(x.dtype)
    y = kops.bitplane_matmul(x2, packed, scale, bits=bits, out_dtype=x.dtype)
    return y.reshape(*lead, -1)


class RMSNorm(nn.Module):
    """RMS norm scaling by ``(1 + g)`` with ``g`` initialised to ones,
    exactly as the JAX package does (so a fresh norm scales by 2)."""

    def __init__(self, dim: int, dev):
        super().__init__()
        self.g = _frozen(torch.ones(dim, dtype=torch.float32, device=dev))


def rmsnorm(params: RMSNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + params.g)
    return y.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def activation(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda t: F.gelu(t, approximate="tanh"),
            "relu": F.relu}[name]


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding on split halves. x: [..., S, H, D], positions:
    [..., S]."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d // 2, dtype=torch.float32,
                                    device=x.device) / (d // 2))
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, D/2]
    angles = angles[..., None, :]                            # [..., S, 1, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_init(generator: torch.Generator, cfg: Config,
               dev) -> nn.ParameterDict:
    e = _normal(generator, (cfg.vocab, cfg.d_model), dev)
    return nn.ParameterDict({"e": _frozen((e * 0.02).to(cfg.adtype))})


def embed_specs() -> dict:
    return {"e": ("vocab", "embed")}
