"""Plain PyTorch reference of a dense decoder with grouped-query attention.

It follows the port's model definition (`src/repro_torch/models`) from
its description, not its code, and imports nothing of the port:

* the token embedding scaled by sqrt(d_model) as held in the weights'
  dtype (bf16: 31.0 for d_model 960, 64.0 for 4096);
* pre-norm layers: RMSNorm scaling by (1 + g), attention with RoPE on
  split halves, query head h reading KV head h // (H / H_kv), logits
  over sqrt(head_dim); then the gated MLP silu(x W_g) * (x W_i) W_o;
* a final RMSNorm, then the tied embedding (or an untied head) as the
  output layer;
* every projection that the configuration packs multiplies by its
  w-bit symmetric quantisation (`quant`), or, with `x_bits`, by the
  exact integer product of quantised activations and weights
  (`int_gemv`).

Everything is float32, TF32 off.  `act` is applied wherever the served
model holds activations in its own dtype; the reference passes the
identity, and the control passes a rounding to a lower precision.

Tokens come as *entries* (`Entries`): one per (batched step, slot) that
a served request occupied, so the reference sees exactly the sequences
the server decoded, and, for a mixture of experts, which tokens shared a
step.  An entry attends to the entries of its own request at positions
up to its own; an idle slot's repeated last token (``real`` False)
attends to the request's real entries and to itself.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from . import int_gemv, quant

Act = Callable[[torch.Tensor], torch.Tensor]


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Entries:
    """Tokens as the server stepped them, all [E] tensors on one device."""
    tokens: torch.Tensor       # input token id
    pos: torch.Tensor          # position within its request
    seg: torch.Tensor          # request id
    step: torch.Tensor         # batched step it ran in
    row: torch.Tensor          # slot within that step
    real: torch.Tensor         # False: an idle slot repeating its last token

    def __len__(self) -> int:
        return int(self.tokens.shape[0])


def embed_scale(d_model: int, dtype: torch.dtype) -> float:
    return float(torch.tensor(math.sqrt(d_model)).to(dtype))


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * \
        (1.0 + g.to(torch.float32))


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [E, H, D] rotated by its entry's position, on split halves."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d // 2, dtype=torch.float32,
                                    device=x.device) / (d // 2))
    ang = (pos.to(torch.float32)[:, None] * freqs)[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Projections:
    """The model's packed projections as the reference computes them."""

    def __init__(self, weights: Dict[str, torch.Tensor], bits: int,
                 x_bits: Optional[int] = None, act: Act = identity):
        self.weights = weights
        self.bits = bits
        self.x_bits = x_bits
        self.act = act

    def __call__(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w = self.weights[name]
        if self.x_bits is not None:
            y, _ = int_gemv.w8a8_linear(x, w, self.bits, self.x_bits)
        else:
            y = x @ quant.dequantized_weight(w, self.bits)
        return self.act(y)


def _segments(ent: Entries):
    """Entries grouped by request: (index [S, L] into the entries, -1
    where padded)."""
    seg = ent.seg
    order = torch.argsort(seg * (1 << 20) + torch.arange(
        len(ent), device=seg.device), stable=True)
    segs, counts = torch.unique_consecutive(seg[order], return_counts=True)
    length = int(counts.max())
    starts = torch.cumsum(counts, 0) - counts
    idx = torch.full((len(segs), length), -1, dtype=torch.long,
                     device=seg.device)
    col = torch.arange(len(ent), device=seg.device) - \
        torch.repeat_interleave(starts, counts)
    idx[torch.repeat_interleave(torch.arange(len(segs), device=seg.device),
                                counts), col] = order
    return idx


def attention(x: torch.Tensor, ent: Entries, idx: torch.Tensor, prefix: str,
              cfg: dict, proj: Projections, act: Act,
              window: Optional[int] = None,
              block: int = 64) -> torch.Tensor:
    """One attention layer over the entries; x is the normed input."""
    hq, hkv, hd = cfg["n_heads"], cfg["kv_heads"], cfg["head_dim"]
    theta = cfg["rope_theta"]
    q = act(rope(proj(f"{prefix}.wq.w", x).view(-1, hq, hd), ent.pos, theta))
    k = act(rope(proj(f"{prefix}.wk.w", x).view(-1, hkv, hd), ent.pos,
                 theta))
    v = proj(f"{prefix}.wv.w", x).view(-1, hkv, hd)
    out = torch.zeros_like(q)
    groups = hq // hkv
    for s0 in range(0, idx.shape[0], block):
        ib = idx[s0:s0 + block]                           # [S, L]
        valid = ib >= 0
        ic = ib.clamp(min=0)
        pos, real = ent.pos[ic], ent.real[ic]
        # [S, Lq, Lk]: own request, earlier real positions, or itself
        m = (real[:, None, :] & (pos[:, None, :] <= pos[:, :, None])) | \
            torch.eye(ib.shape[1], dtype=torch.bool,
                      device=x.device)[None]
        if window:
            m &= pos[:, None, :] > pos[:, :, None] - window
        m &= valid[:, None, :] & valid[:, :, None]
        qs = q[ic]                                       # [S, L, Hq, D]
        ks = k[ic].repeat_interleave(groups, dim=2)
        vs = v[ic].repeat_interleave(groups, dim=2)
        logits = torch.einsum("sqhd,skhd->shqk", qs, ks) / math.sqrt(hd)
        logits = logits.masked_fill(~m[:, None], float("-inf"))
        w = act(torch.softmax(logits, dim=-1).nan_to_num(0.0))
        o = torch.einsum("shqk,skhd->sqhd", w, vs)
        out[ib[valid]] = act(o[valid])
    return proj(f"{prefix}.wo.w", out.reshape(x.shape[0], hq * hd))


def mlp(x: torch.Tensor, prefix: str, proj: Projections,
        act: Act) -> torch.Tensor:
    h = act(torch.nn.functional.silu(proj(f"{prefix}.wg.w", x))) * \
        proj(f"{prefix}.wi.w", x)
    return proj(f"{prefix}.wo.w", act(h))


def embed(weights: Dict[str, torch.Tensor], cfg: dict, ent: Entries,
          act: Act = identity) -> torch.Tensor:
    """The scaled token embeddings [E, d] of the entries."""
    emb = weights["embed.e"]
    return act(emb[ent.tokens].to(torch.float32) *
               embed_scale(cfg["d_model"], emb.dtype))


def layer(weights: Dict[str, torch.Tensor], cfg: dict, ent: Entries,
          idx: torch.Tensor, j: int, h: torch.Tensor, proj: Projections,
          act: Act, ffn: Optional[Callable] = None,
          window: Optional[int] = None) -> torch.Tensor:
    """Layer j over all entries: its input h [E, d] -> its output."""
    p = f"stack.{j}"
    eps = cfg["norm_eps"]
    x = act(rmsnorm(h, weights[f"{p}.n1.g"], eps))
    h = act(h + attention(x, ent, idx, f"{p}.mix", cfg, proj, act,
                          window=window))
    x = act(rmsnorm(h, weights[f"{p}.n2.g"], eps))
    y = ffn(j, x, ent, act) if ffn is not None else \
        mlp(x, f"{p}.ffn", proj, act)
    return act(h + y)


def head(weights: Dict[str, torch.Tensor], cfg: dict, h: torch.Tensor,
         act: Act = identity) -> torch.Tensor:
    """Logits [n, V] of the last layer's outputs h [n, d]."""
    x = act(rmsnorm(h, weights["nf.g"], cfg["norm_eps"]))
    if cfg["tie_embeddings"]:
        return x @ weights["embed.e"].to(torch.float32).T
    return x @ weights["head.w"].to(torch.float32)


def forward(weights: Dict[str, torch.Tensor], cfg: dict, ent: Entries,
            out_mask: torch.Tensor, *, x_bits: Optional[int] = None,
            act: Act = identity, ffn: Optional[Callable] = None,
            window: Optional[int] = None) -> torch.Tensor:
    """Logits [n, V] float32 of the entries where `out_mask` is set.

    `ffn(layer, x_normed, entries, act)` replaces the gated MLP (the
    mixture of experts passes its own); the layers run one after the
    other over all entries.
    """
    no_tf32()
    h = embed(weights, cfg, ent, act)
    proj = Projections(weights, cfg["quant_bits"], x_bits, act)
    idx = _segments(ent)
    for j in range(cfg["n_layers"]):
        h = layer(weights, cfg, ent, idx, j, h, proj, act, ffn, window)
    return head(weights, cfg, h[out_mask], act)
