"""Plain PyTorch reference of DeepSeek-V2's decoder: multi-head latent
attention (MLA) in every layer, a dense gated MLP in the leading layers
and DeepSeekMoE (fine-grained routed experts beside always-on shared
ones) in the rest (arXiv:2405.04434).

It follows the published description, not the port's code, and imports
nothing of the port.  Norms, the embedding and its scale, the untied
head and the packed projections (w-bit symmetric quantisation, taken
here from the float weights) are `dense_gqa`'s; capacity routing is
`moe_decoder`'s.  With x the normed layer input:

* query: ``q = x W_q`` gives [H, nope + rope], split into ``q_nope`` and
  ``q_pe``; there is no query LoRA;
* latent: ``[c, k_pe] = x W_kva`` (kv_lora_rank + rope wide), then
  ``c = RMSNorm(c)``; RoPE on ``q_pe`` and on ``k_pe``, which all heads
  share;
* per head h: ``[k_nope_h, v_h] = c W_kvb,h`` (``W_kvb`` [kv_lora_rank,
  H (nope + v)], head h's columns h (nope + v) onwards, k before v; held
  in bf16, never quantised);
* scores ``s_h(t) = (q_nope_h . k_nope_h(t) + q_pe_h . k_pe(t))
  (nope + rope)^-1/2 m^2``, ``m = 0.1 mscale_all_dim ln(factor) + 1``
  (1.2608 for DeepSeek-V2-Lite);
* output ``y = concat_h(sum_t softmax(s_h)(t) v_h(t)) W_o`` over the
  request's positions up to the entry's own;
* the absorbed form the server decodes with is the same function:
  ``q_nope_h . k_nope_h(t) = (q_nope_h W_uk,h^T) . c(t)`` and ``sum_t
  p_h(t) v_h(t) = (sum_t p_h(t) c(t)) W_uv,h``; this reference expands
  k and v per head;
* YaRN RoPE (the source's ``DeepseekV2YarnRotaryEmbedding``), on split
  halves as the port rotates (the source de-interleaves pairs first, a
  fixed permutation of the RoPE columns): ``inv_freq = freq / factor
  (1 - mask) + freq mask``, the mask 1 minus the linear ramp between the
  correction dims of beta_fast and beta_slow; cos and sin scaled by
  m(mscale) / m(mscale_all_dim);
* routing: ``p = softmax(x W_r)`` over the experts in float32, the
  greedy top k, the gates ``p`` there (renormalised only where
  ``norm_topk`` is set), capacity as `moe_decoder` (the configuration
  sets it so that nothing drops);
* layer output: ``sum gates_i E_i(x) + S(x)``, each ``E_i`` and the
  shared ``S`` (one gated MLP of width n_shared x d_ff, packed)
  ``silu(x W_g) * (x W_i) W_o``.

Everything is float32, TF32 off.  `act` is applied wherever the served
model holds activations in its own dtype (the identity for the
reference, a lower precision for the control).  `forward` and `stages`
take the server's entries, as `moe_decoder`'s do; `stages` gives the
stages' outputs one at a time as they are read (`Lazy`), so that the
check of a long window holds one of them, not all.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Tuple

import torch

from . import dense_gqa, moe_decoder
from .dense_gqa import Act, Entries, identity

ATTN_BYTES = 2 ** 30          # f32 logits of one block of requests


def layer_kinds(cfg: dict) -> List[Tuple[str, str]]:
    pattern = cfg["pattern"]
    return [tuple(pattern[j % len(pattern)]) for j in range(cfg["n_layers"])]


def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def inv_freq(cfg: dict, dev) -> torch.Tensor:
    """YaRN's frequencies [rope / 2], float32."""
    dim, base = cfg["qk_rope_dim"], float(cfg["rope_theta"])
    factor = float(cfg["yarn_factor"])
    freq = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                       device=dev) / dim)
    if factor > 1:
        def corr(rot):
            return dim * math.log(cfg["yarn_original_len"] /
                                  (rot * 2 * math.pi)) / (2 * math.log(base))
        low = max(math.floor(corr(cfg["yarn_beta_fast"])), 0)
        high = min(math.ceil(corr(cfg["yarn_beta_slow"])), dim - 1)
        if low == high:
            high += 0.001
        ramp = ((torch.arange(dim // 2, dtype=torch.float64, device=dev)
                 - low) / (high - low)).clamp(0, 1)
        keep = 1.0 - ramp
        freq = freq / factor * (1 - keep) + freq * keep
    return freq.to(torch.float32)


def rope(x: torch.Tensor, pos: torch.Tensor, cfg: dict) -> torch.Tensor:
    """x [E, H, D] rotated by its entry's position, on split halves."""
    mult = mscale(cfg["yarn_factor"], cfg["yarn_mscale"]) / mscale(
        cfg["yarn_factor"], cfg["yarn_mscale_all_dim"])
    ang = (pos.to(torch.float32)[:, None] * inv_freq(cfg, x.device))[
        :, None, :]
    cos, sin = torch.cos(ang) * mult, torch.sin(ang) * mult
    d = x.shape[-1] // 2
    x1, x2 = x[..., :d], x[..., d:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def scale(cfg: dict) -> float:
    return (cfg["qk_nope_dim"] + cfg["qk_rope_dim"]) ** -0.5 * mscale(
        cfg["yarn_factor"], cfg["yarn_mscale_all_dim"]) ** 2


def attention(weights: Dict[str, torch.Tensor], x: torch.Tensor,
              ent: Entries, idx: torch.Tensor, prefix: str, cfg: dict,
              proj: dense_gqa.Projections, act: Act) -> torch.Tensor:
    """One MLA layer over the entries; x is the normed input."""
    e = x.shape[0]
    h, nope, rd = cfg["n_heads"], cfg["qk_nope_dim"], cfg["qk_rope_dim"]
    vd, lora = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = proj(f"{prefix}.wq.w", x).view(e, h, nope + rd)
    q = torch.cat([q[..., :nope], act(rope(q[..., nope:], ent.pos, cfg))],
                  dim=-1)
    kva = proj(f"{prefix}.wkva.w", x)
    c = act(dense_gqa.rmsnorm(kva[:, :lora], weights[f"{prefix}.kvn.g"],
                              cfg["norm_eps"]))
    k_pe = act(rope(kva[:, None, lora:], ent.pos, cfg))       # [E, 1, R]
    kv = (c @ weights[f"{prefix}.wkvb.w"].to(torch.float32)).view(
        e, h, nope + vd)
    k = torch.cat([kv[..., :nope], k_pe.expand(e, h, rd)], dim=-1)
    v = kv[..., nope:]
    out = torch.zeros((e, h, vd), dtype=torch.float32, device=x.device)
    length = idx.shape[1]
    block = max(1, ATTN_BYTES // (4 * h * length * length))
    for s0 in range(0, idx.shape[0], block):
        ib = idx[s0:s0 + block]                           # [S, L]
        valid = ib >= 0
        ic = ib.clamp(min=0)
        pos, real = ent.pos[ic], ent.real[ic]
        # [S, Lq, Lk]: own request, earlier real positions, or itself
        m = (real[:, None, :] & (pos[:, None, :] <= pos[:, :, None])) | \
            torch.eye(length, dtype=torch.bool, device=x.device)[None]
        m &= valid[:, None, :] & valid[:, :, None]
        logits = torch.einsum("sqhd,skhd->shqk", q[ic], k[ic]) * scale(cfg)
        logits = logits.masked_fill(~m[:, None], float("-inf"))
        w = act(torch.softmax(logits, dim=-1).nan_to_num(0.0))
        o = torch.einsum("shqk,skhd->sqhd", w, v[ic])
        out[ib[valid]] = act(o[valid])
    return proj(f"{prefix}.wo.w", out.reshape(e, h * vd))


def moe(weights: Dict[str, torch.Tensor], cfg: dict, layer: int,
        x: torch.Tensor, ent: Entries, proj: dense_gqa.Projections,
        act: Act) -> torch.Tensor:
    """Routed experts (groups and capacity as `moe_decoder`) plus the
    shared experts, over the normed input x of every entry."""
    p = f"stack.{layer}.ffn"
    e, k = cfg["n_experts"], cfg["top_k"]
    probs = torch.softmax(x @ weights[f"{p}.router.w"].to(torch.float32),
                          dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    if cfg["norm_topk"]:
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    per_step = int(torch.bincount(ent.step).max())
    group = cfg["moe_group"] if per_step % cfg["moe_group"] == 0 \
        else per_step
    group_of = ent.step * (per_step // group) + ent.row // group
    keep = moe_decoder.keep_mask(idx, group_of, e, moe_decoder.capacity(
        group, k, cfg["capacity_factor"], e))
    y = torch.zeros_like(x)
    for ex in range(e):
        tok, choice = torch.nonzero((idx == ex) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        wi = weights[f"{p}.wi"][ex].to(torch.float32)
        wg = weights[f"{p}.wg"][ex].to(torch.float32)
        wo = weights[f"{p}.wo"][ex].to(torch.float32)
        xe = x[tok]
        hid = act(act(torch.nn.functional.silu(act(xe @ wg))) *
                  act(xe @ wi))
        y.index_add_(0, tok, act(hid @ wo) * gates[tok, choice][:, None])
    y = act(y)
    if cfg["n_shared"]:
        y = act(y + dense_gqa.mlp(x, f"stack.{layer}.ffn_shared", proj,
                                  act))
    return y


def layer(weights: Dict[str, torch.Tensor], cfg: dict, ent: Entries,
          idx: torch.Tensor, j: int, h: torch.Tensor,
          proj: dense_gqa.Projections, act: Act) -> torch.Tensor:
    """Layer j over all entries: its input h [E, d] -> its output."""
    p = f"stack.{j}"
    eps = cfg["norm_eps"]
    x = act(dense_gqa.rmsnorm(h, weights[f"{p}.n1.g"], eps))
    h = act(h + attention(weights, x, ent, idx, f"{p}.mix", cfg, proj, act))
    x = act(dense_gqa.rmsnorm(h, weights[f"{p}.n2.g"], eps))
    if layer_kinds(cfg)[j][1] == "mlp":
        y = dense_gqa.mlp(x, f"{p}.ffn", proj, act)
    else:
        y = moe(weights, cfg, j, x, ent, proj, act)
    return act(h + y)


def forward(weights: Dict[str, torch.Tensor], cfg: dict, ent: Entries,
            out_mask: torch.Tensor, *, act: Act = identity) -> torch.Tensor:
    """Logits [n, V] float32 of the entries where `out_mask` is set."""
    dense_gqa.no_tf32()
    proj = dense_gqa.Projections(weights, cfg["quant_bits"], None, act)
    idx = dense_gqa._segments(ent)
    h = dense_gqa.embed(weights, cfg, ent, act)
    for j in range(cfg["n_layers"]):
        h = layer(weights, cfg, ent, idx, j, h, proj, act)
    return dense_gqa.head(weights, cfg, h[out_mask], act)


class Lazy:
    """A sequence of `n` tensors, item j made by `item(j)` each time it
    is read, so that iterating holds one at a time: the stages of a
    window of 1,000 steps of 32 slots are 28 float32 tensors of 0.26 GB.
    ``lazy + list`` is the same with the list's items after."""

    def __init__(self, n: int, item: Callable[[int], torch.Tensor]):
        self.n, self.item = n, item

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, j: int) -> torch.Tensor:
        if not -self.n <= j < self.n:
            raise IndexError(j)
        return self.item(j % self.n)

    def __iter__(self) -> Iterator[torch.Tensor]:
        return (self.item(j) for j in range(self.n))

    def __add__(self, more: list) -> "Lazy":
        return Lazy(self.n + len(more), lambda j: self.item(j) if
                    j < self.n else more[j - self.n])


def stages(weights: Dict[str, torch.Tensor], cfg: dict, ent: Entries,
           inputs: List[torch.Tensor], out_mask: torch.Tensor,
           act: Act = identity) -> Tuple[Lazy, torch.Tensor]:
    """Each stage from the served model's own input to it, as
    `moe_decoder.stages`: the embedding's output, every layer's from its
    served input (as a `Lazy` sequence, each computed when read), and
    the head's logits [n, V] from the served last output of the entries
    where `out_mask` is set."""
    dense_gqa.no_tf32()
    proj = dense_gqa.Projections(weights, cfg["quant_bits"], None, act)
    idx = dense_gqa._segments(ent)

    def stage(j: int) -> torch.Tensor:
        if j == 0:
            return dense_gqa.embed(weights, cfg, ent, act)
        return layer(weights, cfg, ent, idx, j - 1,
                     inputs[j - 1].to(torch.float32), proj, act)
    return Lazy(cfg["n_layers"] + 1, stage), dense_gqa.head(
        weights, cfg, inputs[-1][out_mask].to(torch.float32), act)
