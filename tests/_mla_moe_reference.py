"""Plain PyTorch reference of DeepSeek-V2's decoder, for the port's CPU
tests: multi-head latent attention (MLA) and DeepSeekMoE, written from
the paper (arXiv:2405.04434) and the source's configuration, in float32
with TF32 off.  It imports nothing of the port.

Weights come as a dict keyed by the port's state-dict names, every
projection a float [in, out] matrix under ``<name>.w`` (the tests hand
the packed ones over dequantised).  Conventions the port states and this
follows: RMSNorm scales by (1 + g); the token embedding is scaled by
sqrt(d_model); RoPE rotates split halves; ``cfg`` is a plain dict of the
config's fields.

Equations, x the normed layer input:

* q = x W_q -> [H, nope + rope], split into q_nope, q_pe;
  [c, k_pe] = x W_kva, c = RMSNorm(c); RoPE (YaRN frequencies) on q_pe
  and k_pe, k_pe shared by the heads; [k_nope_h, v_h] = c W_kvb,h;
* s_h(t) = (q_nope_h . k_nope_h(t) + q_pe_h . k_pe(t)) (nope + rope)^-1/2
  m^2 with m = 0.1 mscale_all_dim ln(factor) + 1;
  y = concat_h(sum_t softmax(s_h)(t) v_h(t)) W_o, causal;
* MoE: p = softmax(x W_r), the top k, gates p there (renormalised only
  with ``norm_topk``), sum_i gate_i E_i(x) + S(x), each E_i and the
  shared S the gated MLP silu(x W_g) * (x W_i) W_o; nothing dropped.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch.nn import functional as F

Weights = Dict[str, torch.Tensor]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * \
        (1.0 + g.float())


def yarn_inv_freq(dim, base, factor, original, beta_fast, beta_slow):
    """[dim / 2] float64: YaRN's frequencies, from the formulas."""
    freq = [base ** (-2 * i / dim) for i in range(dim // 2)]
    if factor <= 1:
        return torch.tensor(freq, dtype=torch.float64)

    def corr(rot):
        return dim * math.log(original / (rot * 2 * math.pi)) / (
            2 * math.log(base))
    low = max(math.floor(corr(beta_fast)), 0)
    high = min(math.ceil(corr(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    out = []
    for i, f in enumerate(freq):
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        extrapolate = 1.0 - ramp
        out.append(f / factor * (1 - extrapolate) + f * extrapolate)
    return torch.tensor(out, dtype=torch.float64)


def mscale(factor, m):
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def rope(x, pos, cfg):
    """x [..., S, H, D] rotated at positions pos [S] on split halves."""
    inv = yarn_inv_freq(cfg["qk_rope_dim"], cfg["rope_theta"],
                        cfg["yarn_factor"], cfg["yarn_original_len"],
                        cfg["yarn_beta_fast"], cfg["yarn_beta_slow"]).float()
    mult = mscale(cfg["yarn_factor"], cfg["yarn_mscale"]) / mscale(
        cfg["yarn_factor"], cfg["yarn_mscale_all_dim"])
    ang = (pos.float()[:, None] * inv)[:, None, :]
    cos, sin = torch.cos(ang) * mult, torch.sin(ang) * mult
    d = x.shape[-1] // 2
    x1, x2 = x[..., :d], x[..., d:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(w: Weights, p: str, x, cfg):
    """Causal MLA over x [B, S, D] (normed), k and v expanded per head."""
    b, s, _ = x.shape
    h, nope, rd = cfg["n_heads"], cfg["qk_nope_dim"], cfg["qk_rope_dim"]
    vd, lora = cfg["v_head_dim"], cfg["kv_lora_rank"]
    pos = torch.arange(s)
    q = (x @ w[f"{p}.wq.w"].float()).view(b, s, h, nope + rd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, cfg)], dim=-1)
    kva = x @ w[f"{p}.wkva.w"].float()
    c = rmsnorm(kva[..., :lora], w[f"{p}.kvn.g"], cfg["norm_eps"])
    k_pe = rope(kva[..., None, lora:], pos, cfg)              # [B, S, 1, R]
    kv = (c @ w[f"{p}.wkvb.w"].float()).view(b, s, h, nope + vd)
    k = torch.cat([kv[..., :nope], k_pe.expand(b, s, h, rd)], dim=-1)
    v = kv[..., nope:]
    scale = (nope + rd) ** -0.5 * mscale(
        cfg["yarn_factor"], cfg["yarn_mscale_all_dim"]) ** 2
    logits = torch.einsum("bshd,bthd->bhst", q, k) * scale
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    logits = logits.masked_fill(~causal, float("-inf"))
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(logits, -1), v)
    return out.reshape(b, s, h * vd) @ w[f"{p}.wo.w"].float()


def mlp(w: Weights, p: str, x):
    h = F.silu(x @ w[f"{p}.wg.w"].float()) * (x @ w[f"{p}.wi.w"].float())
    return h @ w[f"{p}.wo.w"].float()


def moe(w: Weights, p: str, x, cfg):
    """The routed experts of ``{p}.ffn`` and the shared ones of
    ``{p}.ffn_shared`` over tokens x [..., D]; no token is dropped."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    probs = torch.softmax(x2 @ w[f"{p}.ffn.router.w"].float(), dim=-1)
    gates, idx = torch.topk(probs, cfg["top_k"], dim=-1)
    if cfg["norm_topk"]:
        gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(x2)
    for t in range(x2.shape[0]):
        for gate, e in zip(gates[t], idx[t]):
            wi = w[f"{p}.ffn.wi"][e].float()
            wg = w[f"{p}.ffn.wg"][e].float()
            wo = w[f"{p}.ffn.wo"][e].float()
            y[t] += gate * ((F.silu(x2[t] @ wg) * (x2[t] @ wi)) @ wo)
    if cfg["n_shared"]:
        y = y + mlp(w, f"{p}.ffn_shared", x2)
    return y.reshape(shape)


def layer_kinds(cfg):
    pattern = cfg["pattern"]
    return [tuple(pattern[j % len(pattern)]) for j in range(cfg["n_layers"])]


def forward(w: Weights, cfg, tokens) -> torch.Tensor:
    """Logits [B, S, V] of tokens [B, S]."""
    no_tf32()
    eps = cfg["norm_eps"]
    emb = w["embed.e"]
    x = emb[tokens].float() * float(
        torch.tensor(math.sqrt(cfg["d_model"])).to(emb.dtype))
    for j, (_, f) in enumerate(layer_kinds(cfg)):
        p = f"stack.{j}"
        x = x + attention(w, f"{p}.mix", rmsnorm(x, w[f"{p}.n1.g"], eps), cfg)
        h = rmsnorm(x, w[f"{p}.n2.g"], eps)
        x = x + (mlp(w, f"{p}.ffn", h) if f == "mlp" else moe(w, p, h, cfg))
    x = rmsnorm(x, w["nf.g"], eps)
    return x @ w["head.w"].float()
