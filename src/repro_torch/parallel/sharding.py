"""Logical-axis sharding: names -> mesh axes via a rules table (MaxText-style).

The port of `repro.parallel.sharding`.  Every parameter and activation
dimension carries a *logical* name ("embed", "mlp", "heads", ...).  A
rules table maps logical names to mesh axes; changing the distribution
strategy (pure TP -> FSDP, adding SP) is a rules edit, not a model edit.

A spec is a plain tuple with one entry per dim: None (replicated), one
mesh axis name, or a tuple of names - JAX's `PartitionSpec` without JAX,
so ``tuple(P(...))`` of the JAX package's spec equals the port's.  On a
`torch.distributed.device_mesh.DeviceMesh` a spec becomes `DTensor`
placements (`placements`): ``Shard(d)`` on every mesh dim that tensor
dim d names, ``Replicate()`` on the others.  A dim named by two mesh
axes (``("pod", "data")``) is sharded over both, in mesh order, which is
JAX's major-to-minor order for the rules' axis order.

Mesh axes:
  pod    - data-parallel across pods (slow inter-pod links)
  data   - data parallel / FSDP within a pod
  model  - tensor/expert/sequence parallel within a pod

State is updated in place, placed or not: a `DTensor` refuses in-place
writes that change placements, so a new value is first redistributed to
the placements of the tensor it is written into (`like`), and a write
into some slots of a sharded axis becomes a masked select over all of
them (`set_rows`).  For plain tensors both are the port's usual
in-place writes, which the captured decode step on one card relies on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard, distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map

Rules = Dict[str, Optional[Tuple[str, ...]]]
Spec = Tuple[Any, ...]

# default rules: TP on model axis, batch on (pod, data), FSDP for expert and
# mlp dims over data (so giant MoE models fit), sequence-parallel KV cache.
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "mlp": ("model",),            # FFN hidden dim
    "heads": ("model",),          # attention query heads
    "kv_heads": None,             # few KV heads: replicate, shard seq instead
    "head_dim": None,
    "qkv": ("model",),
    "vocab": ("model",),
    "expert": ("data",),          # expert weights FSDP'd over data axis
    "expert_mlp": ("model",),     # expert FFN hidden dim
    "moe_tokens": ("pod", "data"),  # token-group dim of dispatched buffers
    "capacity": None,
    "cache_seq": ("model",),      # KV cache sequence dim (flash-decoding SP)
    "state": ("model",),          # recurrent state dim (RG-LRU / mLSTM)
    "layers": None,               # stacked-scan layer dim
    "conv": None,
    "bits": None,                 # bit-plane dim of packed weights
    "packed_in": None,            # packed (K/32) dim: replicate with kv...
    "grid": ("pod", "data"),      # ComefaGrid slot axis: independent sweeps
}


# mesh axes available to specs; drivers set this from the mesh's dim names
# so a single-pod mesh silently drops the "pod" axis from every rule
_ACTIVE_AXES: Tuple[str, ...] = ("pod", "data", "model")
# rules active for model-internal activation constraints: drivers install
# the per-arch rules here so `constrain()` deep inside layers sees the same
# strategy the placed state uses
_ACTIVE_RULES: Optional[Rules] = None


def set_mesh_axes(names: Sequence[str]) -> None:
    global _ACTIVE_AXES
    _ACTIVE_AXES = tuple(names)


def set_active_rules(rules: Optional[Rules]) -> None:
    global _ACTIVE_RULES
    _ACTIVE_RULES = dict(rules) if rules else None


def spec_for(logical_axes: Sequence[Optional[str]],
             rules: Optional[Rules] = None,
             mesh_axes: Optional[Sequence[str]] = None) -> Spec:
    """Logical names (one per dim, None = replicated) -> spec tuple.

    `mesh_axes` restricts the rule resolution to an explicit mesh's axis
    names without touching the module-global default installed by
    `set_mesh_axes`.
    """
    rules = dict(DEFAULT_RULES, **(rules if rules is not None
                                   else (_ACTIVE_RULES or {})))
    active = tuple(mesh_axes) if mesh_axes is not None else _ACTIVE_AXES
    parts = []
    used: set = set()
    for name in logical_axes:
        if name is None:
            parts.append(None)
            continue
        axes = rules.get(name)
        if axes is None:
            parts.append(None)
        else:
            # a mesh axis may appear only once in a spec, and must exist
            ax = tuple(a for a in axes if a not in used and a in active)
            used.update(ax)
            parts.append(ax if len(ax) > 1 else (ax[0] if ax else None))
    return tuple(parts)


def _is_axes(x) -> bool:
    """A leaf of a spec tree: logical names, or a spec, whose entries may
    be tuples of mesh axes (``("pod", "data")`` on a multi-pod mesh)."""
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) or (
            isinstance(a, tuple) and all(isinstance(b, str) for b in a))
        for a in x)


def tree_map(fn, tree, *rest, is_leaf=_is_axes):
    """`fn` over the leaves of nested dicts and lists (a leaf is what
    `is_leaf` accepts: by default a tuple of logical names); `rest` are
    trees of the same structure whose matching entries are passed too."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    raise TypeError(f"not a spec tree node: {type(tree).__name__}")


def tree_specs(logical_tree: Any, rules: Optional[Rules] = None) -> Any:
    """Map a tree of logical-axis tuples to a tree of spec tuples."""
    return tree_map(lambda axes: spec_for(axes, rules), logical_tree)


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(mesh: DeviceMesh, spec: Spec) -> Tuple[Placement, ...]:
    """One spec -> `DTensor` placements on `mesh`, one per mesh dim."""
    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for d, p in enumerate(spec):
        for a in ((p,) if isinstance(p, str) else (p or ())):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def shardings(mesh: DeviceMesh, spec_tree: Any) -> Any:
    """A tree of specs -> the tree of their `placements` on `mesh`."""
    return tree_map(lambda s: placements(mesh, s), spec_tree)


def _prune_spec(spec: Spec, shape, mesh_shape) -> Spec:
    """Drop mesh axes whose product doesn't divide the dim size.

    This is what makes one rules table serve every arch: 4-head xlstm
    params, whisper's 51865 vocab, 8-expert MoEs on a 16-wide axis and
    batch-1 decode all degrade gracefully to replication on that dim.
    """
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, p in zip(shape, parts):
        if p is None:
            out.append(None)
            continue
        axes = (p,) if isinstance(p, str) else tuple(p)
        while axes:
            size = 1
            for a in axes:
                size *= mesh_shape[a]
            if dim % size == 0:
                break
            axes = axes[:-1]
        out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return tuple(out)


def shardings_pruned(mesh: DeviceMesh, spec_tree: Any,
                     struct_tree: Any) -> Any:
    """Placements with dimension-aware axis pruning (see `_prune_spec`);
    `struct_tree` holds, at each spec's place, anything with a
    ``.shape`` (a tensor, a `DTensor`, a meta tensor)."""
    ms = mesh_shape(mesh)
    return tree_map(lambda s, st: placements(
        mesh, _prune_spec(s, tuple(st.shape), ms)), spec_tree, struct_tree)


def place(x: torch.Tensor, mesh: DeviceMesh,
          where: Sequence[Placement]) -> DTensor:
    """`x` as a `DTensor` on `mesh` with placements `where`; a `DTensor`
    is redistributed, a plain tensor (the same values on every rank)
    is cut into this rank's shard locally, with no collective."""
    if isinstance(x, DTensor):
        return x.redistribute(mesh, tuple(where))
    return distribute_tensor(x, mesh, tuple(where), src_data_rank=None)


def place_module(module: torch.nn.Module, mesh: DeviceMesh,
                 where: Dict[str, Sequence[Placement]]) -> torch.nn.Module:
    """Replace each param and buffer of `module` named in `where` (its
    state-dict names) by its `DTensor` on `mesh`, in place; a param
    keeps its ``requires_grad``."""
    for name, pl in where.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        old = getattr(owner, leaf)
        new = place(old.detach(), mesh, pl)
        if isinstance(old, torch.nn.Parameter):
            setattr(owner, leaf, torch.nn.Parameter(
                new, requires_grad=old.requires_grad))
        else:
            owner.register_buffer(leaf, new)
    return module


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]],
              rules: Optional[Rules] = None) -> torch.Tensor:
    """Activation sharding constraint by logical names: a plain tensor
    (one device, no mesh) comes back as it is; a `DTensor` is
    redistributed over its own mesh to the pruned spec."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    spec = _prune_spec(spec_for(logical_axes, rules,
                                mesh_axes=mesh.mesh_dim_names),
                       tuple(x.shape), mesh_shape(mesh))
    return x.redistribute(mesh, placements(mesh, spec))


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape)``.  A `DTensor` whose sharding the reshape
    cannot keep (a sharded dim split into parts that its ranks do not
    divide, as 15 heads on a 16-wide model axis) first has every dim from
    the first changed one on replicated, as XLA reshards there; and its
    gradient is brought back to the result's placements, contiguous,
    before the reshape's backward (`_GradLike`), which would otherwise
    meet the same split.  A plain tensor is reshaped as it is."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    x = _local_contiguous(x)  # DTensor's reshape views each local shard
    try:
        y = x.reshape(*shape)
    except RuntimeError:      # DTensor's view rules refuse or mis-split
        keep = 0
        while keep < min(x.dim(), len(shape)) and \
                x.shape[keep] == shape[keep]:
            keep += 1
        where = [Replicate() if p.is_shard() and p.dim >= keep else p
                 for p in x.placements]
        y = x.redistribute(x.device_mesh, where).reshape(*shape)
    return _GradLike.apply(y)


def embedding(tokens: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, e)``.  A `DTensor` table looks up on each
    rank's shards (`local_map`): where the vocab is sharded, each rank
    gathers the rows it holds, zeroes the others, and the output is a
    partial sum (one nonzero row a token, so exact); where the tokens'
    batch is sharded, the table is gathered there and the output keeps
    the batch's sharding; an embed dim shard stays one.  This is the
    vocab-parallel lookup of `DTensor`'s own rule without its masked
    placement, whose mask some torch releases lose on the way to the
    reduction."""
    if not isinstance(e, DTensor):
        return torch.nn.functional.embedding(tokens, e)
    mesh = e.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tok_at, e_at, out_at = [], [], []
    for pt, pe in zip(tokens.placements, e.placements):
        if pt.is_shard(0):
            tok_at.append(Shard(0))
            e_at.append(Replicate())
            out_at.append(Shard(0))
        elif pe.is_shard(0):
            tok_at.append(Replicate())
            e_at.append(Shard(0))
            out_at.append(Partial())
        elif pe.is_shard(1):
            tok_at.append(Replicate())
            e_at.append(Shard(1))
            out_at.append(Shard(tokens.dim()))
        else:
            tok_at.append(Replicate())
            e_at.append(Replicate())
            out_at.append(Replicate())
    shape, offset = compute_local_shape_and_global_offset(
        tuple(e.shape), mesh, e_at)
    lo, n = int(offset[0]), int(shape[0])
    vocab_split = any(p.is_partial() for p in out_at)

    def lookup(tl, el):
        if not vocab_split:
            return torch.nn.functional.embedding(tl, el)
        idx = tl - lo
        held = (idx >= 0) & (idx < n)
        rows = torch.nn.functional.embedding(idx.clamp(0, n - 1), el)
        return rows * held[..., None].to(rows.dtype)
    # the table's gradient from a rank's slice of the batch is a partial
    # sum over the ranks that split the batch
    e_grad_at = [Partial() if pt == Shard(0) else pe
                 for pt, pe in zip(tok_at, e_at)]
    return local_map(lookup, out_placements=out_at,
                     in_placements=(tuple(tok_at), tuple(e_at)),
                     in_grad_placements=(tuple(tok_at), tuple(e_grad_at)),
                     device_mesh=mesh, redistribute_inputs=True)(tokens, e)


def contiguous_grad(y: torch.Tensor) -> torch.Tensor:
    """y; a `DTensor`'s gradient reaches the op that made it in y's
    placements and contiguous (`_GradLike`), where `DTensor`'s backward
    of a product views it.  A plain tensor comes back as it is."""
    return _GradLike.apply(y) if isinstance(y, DTensor) else y


def pointwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise `fn`; a `DTensor` runs it on each
    rank's shard (a partial sum is reduced first), for ops that
    `DTensor` has no sharding rule for (``log_sigmoid_backward``)."""
    if not isinstance(x, DTensor):
        return fn(x)
    where = [Replicate() if p.is_partial() else p for p in x.placements]
    return local_map(fn, out_placements=where, in_placements=(tuple(where),),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)


class _GradLike(torch.autograd.Function):
    """Identity forward; backward brings the gradient to the forward
    value's placements, contiguous, before it meets a reshape's backward
    (a view, which a transposed or unevenly split gradient refuses)."""

    @staticmethod
    def forward(ctx, y):
        # the gradient of a partial sum is replicated
        ctx.mesh = y.device_mesh
        ctx.where = tuple(Replicate() if p.is_partial() else p
                          for p in y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor):
            return _local_contiguous(g.redistribute(ctx.mesh, ctx.where))
        return g.contiguous()


def _local_contiguous(x: DTensor) -> DTensor:
    """x with a contiguous local shard (`DTensor.contiguous` looks at the
    global layout only)."""
    if x._local_tensor.is_contiguous():
        return x
    return x.clone(memory_format=torch.contiguous_format)


def like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """x redistributed to `ref`'s placements where `ref` is a `DTensor`
    (so that ``ref.copy_(like(x, ref))`` writes each shard locally);
    else x as it is."""
    if isinstance(ref, DTensor):
        return place(x, ref.device_mesh, ref.placements)
    return x


def set_rows(dst: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
             values: torch.Tensor) -> torch.Tensor:
    """``dst[rows[i], cols[i]] = values[i]`` in place, for a dst [B, T,
    ...], and dst returned.  A `DTensor` (its T axis may be sharded,
    and index writes on a sharded axis are refused) takes a masked
    select over every slot, copied into it shard by shard."""
    if isinstance(dst, DTensor):
        hit = torch.zeros(tuple(dst.shape[:2]), dtype=torch.bool,
                          device=rows.device)
        hit[rows, cols] = True
        hit = hit.reshape(*hit.shape, *([1] * (dst.dim() - 2)))
        new = torch.where(hit, values.to(dst.dtype)[:, None], dst)
        return dst.copy_(like(new, dst))
    dst[rows, cols] = values.to(dst.dtype)
    return dst


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Distribution strategy knobs threaded through train/serve steps."""
    rules: Optional[Rules] = None          # overrides of DEFAULT_RULES
    fsdp: bool = False                     # shard params over data axis too

    def resolved(self) -> Rules:
        rules = dict(DEFAULT_RULES, **(self.rules or {}))
        if self.fsdp:
            # FSDP/ZeRO-3: fold the data (and, when present, pod) axes into
            # the big weight dims; on a single-pod mesh the pod axis prunes
            # away automatically.
            rules["mlp"] = ("model",)
            rules["embed"] = (("pod", "data") if "pod" in _ACTIVE_AXES
                              else ("data",))
            rules["expert"] = (("pod", "data") if "pod" in _ACTIVE_AXES
                               else ("data",))
        return rules
