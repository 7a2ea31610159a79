"""Plain PyTorch reference of a decoder whose feed-forward is a top-k
mixture of experts with capacity routing (GShard), over windowed
attention.

The attention, norms, embedding and output layer are `dense_gqa`'s, with
causal attention limited to the last `window` positions.  The layer's
feed-forward follows the port's published semantics, not its code:

* router logits x W_r in float32, a softmax, the top k experts, their
  probabilities renormalised to sum to 1 (the gates);
* tokens are routed in groups: the tokens of one batched step, in slot
  order (split into groups of `moe_group` where that divides them);
* each expert takes at most ``int(g * k * capacity_factor / E) + 1``
  (token, choice) pairs of a group of g tokens, every token's first
  choice queued ahead of any token's second; the rest are dropped, and a
  dropped choice adds nothing (the kept gates are not renormalised);
* an expert is the gated MLP silu(x W_g) * (x W_i) W_o of its own
  weights.

Routing groups are why the reference runs over the server's entries
(one per step and slot) layer by layer: which tokens share a step
decides which choices are dropped.

`stages` follows the served model stage by stage instead: it takes each
layer's input as the server computed it and runs that one layer, so a
routing choice that rounding tipped the other way changes one layer's
output for one token, not every later token.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import dense_gqa
from .dense_gqa import Act, Entries, identity


def route(x: torch.Tensor, router_w: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates [T, k], experts [T, k]) of tokens x [T, d]."""
    probs = torch.softmax(x.to(torch.float32) @ router_w.to(torch.float32),
                          dim=-1)
    vals, idx = torch.topk(probs, top_k, dim=-1)
    return vals / vals.sum(-1, keepdim=True).clamp(min=1e-9), idx


def capacity(group: int, top_k: int, capacity_factor: float,
             n_experts: int) -> int:
    return int(group * top_k * capacity_factor / n_experts) + 1


def keep_mask(idx: torch.Tensor, group_of: torch.Tensor, n_experts: int,
              cap: int) -> torch.Tensor:
    """keep [T, k]: a (token, choice) pair's place in its expert's queue
    within its group is below `cap`; choice 0 of every token of a group
    comes first, then choice 1, each in token order (the order of the
    rows of `idx`).  `group_of` [T] numbers each token's group."""
    t, k = idx.shape
    dev = idx.device
    choice = torch.arange(k, device=dev)[None, :].expand(t, k)
    token = torch.arange(t, device=dev)[:, None].expand(t, k)
    group = group_of[:, None].expand(t, k)
    queue = ((group * k + choice) * t + token).reshape(-1)
    bucket = (group * n_experts + idx).reshape(-1)
    # sort by (group, expert), then by place in the queue
    order = torch.argsort(bucket * (int(queue.max()) + 1) + queue)
    ranked = bucket[order]
    first = torch.searchsorted(ranked, ranked)
    place = torch.empty(t * k, dtype=torch.long, device=dev)
    place[order] = torch.arange(t * k, device=dev) - first
    return (place < cap).view(t, k)


def moe_ffn(weights: Dict[str, torch.Tensor], cfg: dict):
    """The `ffn` hook of `dense_gqa.forward` for an MoE layer."""
    e, k = cfg["n_experts"], cfg["top_k"]

    def ffn(layer: int, x: torch.Tensor, ent: Entries, act: Act):
        p = f"stack.{layer}.ffn"
        gates, idx = route(x, weights[f"{p}.router.w"], k)
        per_step = int(torch.bincount(ent.step).max())
        group = cfg["moe_group"] if per_step % cfg["moe_group"] == 0 \
            else per_step
        # entries come in (step, slot) order: a group is `group`
        # consecutive slots of one step
        group_of = ent.step * (per_step // group) + ent.row // group
        keep = keep_mask(idx, group_of, e, capacity(
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
            h = act(act(torch.nn.functional.silu(act(xe @ wg))) *
                    act(xe @ wi))
            y.index_add_(0, tok, act(h @ wo) * gates[tok, choice][:, None])
            del wi, wg, wo
        return act(y)
    return ffn


def forward(weights: Dict[str, torch.Tensor], cfg: dict, ent: Entries,
            out_mask: torch.Tensor, *, act: Act = identity) -> torch.Tensor:
    """Logits [n, V] float32 of the entries where `out_mask` is set."""
    return dense_gqa.forward(weights, cfg, ent, out_mask, act=act,
                             ffn=moe_ffn(weights, cfg),
                             window=cfg["window"])


def stages(weights: Dict[str, torch.Tensor], cfg: dict, ent: Entries,
           inputs: List[torch.Tensor], out_mask: torch.Tensor,
           act: Act = identity) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Each stage from the served model's own input to it.

    `inputs` [n_layers + 1] holds, for every entry, each layer's input
    as served and, last, the last layer's output.  Returns the stages'
    outputs (the embedding's, then every layer's) as the reference gives
    them from those inputs, and the head's logits [n, V] from the served
    last output of the entries where `out_mask` is set."""
    dense_gqa.no_tf32()
    proj = dense_gqa.Projections(weights, cfg["quant_bits"], None, act)
    idx = dense_gqa._segments(ent)
    ffn = moe_ffn(weights, cfg)
    outs = [dense_gqa.embed(weights, cfg, ent, act)]
    for j in range(cfg["n_layers"]):
        outs.append(dense_gqa.layer(weights, cfg, ent, idx, j,
                                    inputs[j].to(torch.float32), proj, act,
                                    ffn, cfg["window"]))
    return outs, dense_gqa.head(weights, cfg,
                                inputs[-1][out_mask].to(torch.float32), act)
