DOC = """Multi-pod dry run: count the real step of every (arch x shape x mesh)
cell on a fake process group of the production mesh's size.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]

The port of `repro.launch.dryrun`, without XLA.  Each cell starts a
``"fake"`` `torch.distributed` group of 256 (single pod, 16x16) or 512
(2x16x16) ranks, as rank 0 (`fake_group`), builds the production mesh
on it (`launch.mesh.make_production_mesh`), places the model, state and
inputs as tensors on the ``meta`` device (shapes, no storage) by the
same spec functions and rules the real run uses, and runs the port's
real step once (the mesh train step, the prefill forward with
``last_only=True``, or the decode step) under a counting dispatch mode
(`Counter`).  No kernel runs, nothing is allocated, and no GPU is
needed; the group is destroyed on exit, also on error.  It refuses to
start while a real group is running.

The mode counts below `DTensor`: a `DTensor` op comes to it as the
local ops it runs on this rank's shards and the collectives of the
redistributes it needs, as a rank would issue them.  It counts ops on
meta tensors only: `DTensor`'s sharding propagation runs its own ops
on fake and small host tensors, which are not the step's.

Each cell records, for one rank, into results/torch/dryrun/<cell>.json:

  flops            the matmul and attention FLOPs of `FlopCounterMode`'s
                   formulas on the local ops this rank runs; the
                   bit-plane kernel (#1) counts 2 M K N a call;
  bytes_accessed   the bytes of every local op's inputs and outputs, op
                   by op, with no fusion (views move nothing and count
                   nothing);
  memory_analysis  argument_bytes: this rank's bytes of the state and the
                   batch; temp_bytes: the peak of the tensors the step
                   makes that are alive at once (this module's own tally,
                   by storage), above the arguments; output_bytes: the
                   new tensors the step returns;
  collective_bytes the result bytes of each collective the step issues,
                   by JAX's kind names (all-reduce, all-gather,
                   reduce-scatter, all-to-all, collective-permute);
  lower_s          the seconds to build and place the step's inputs (the
                   JAX key's XLA lowering has no counterpart);
  compile_s        the seconds to run the step on meta tensors (the
                   counterpart of XLA's compile).

A train or prefill cell of an arch whose step loops over the tokens
(xLSTM's sLSTM) is counted at three shorter lengths and at one and two
pattern periods, and extrapolated to its length and depth
(`count_cell`, `count_periods`; the JSON's ``counting`` says so).

--reduced takes the arch's reduced config (`models.common.reduced`) and
--mesh-shape DxM (or PxDxM) a fake mesh of that shape in place of the
production one, for a quick run; --results DIR writes under DIR.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .. import configs
from ..models import common as cm
from ..models import lm
from ..models import recurrent
from ..models.common import Config
from ..parallel import sharding as shd
from ..train import optimizer as opt
from ..train import step as train_step_mod
from . import mesh as mesh_mod
from . import shapes as shapes_mod

# the meshes' device type.  Nothing runs on it: the tensors are meta.
# DTensor's sharding propagation makes fake tensors of the mesh's type
# for some ops, which a torch built without CUDA cannot make on "cuda",
# so the analysis names the CPU; the counts do not depend on it.
MESH_DEVICE = "cpu"

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "torch")

# per-arch training-scale settings: FSDP + microbatches + int8 Adam second
# moment for the models whose weights, gradients and moments would not
# fit in one device's memory under tensor parallelism alone
TRAIN_SETTINGS: Dict[str, Dict[str, Any]] = {
    "arctic-480b": dict(fsdp=True, microbatches=8, int8_v=True,
                        accum="bfloat16"),
    # 8 experts < 16-wide data axis: shard expert weights over their
    # embed/mlp dims instead (rules override), FSDP over data
    "mixtral-8x7b": dict(fsdp=True, microbatches=8, int8_v=True,
                         accum="bfloat16", rules={"expert": None}),
    "gemma2-27b": dict(fsdp=True, microbatches=8, int8_v=False,
                       accum="bfloat16"),
    "gemma3-27b": dict(fsdp=True, microbatches=8, int8_v=False,
                       accum="bfloat16"),
    "starcoder2-7b": dict(fsdp=True, microbatches=4, int8_v=False),
    "recurrentgemma-2b": dict(fsdp=False, microbatches=4, int8_v=False),
    "paligemma-3b": dict(fsdp=False, microbatches=4, int8_v=False),
}
DEFAULT_TRAIN = dict(fsdp=False, microbatches=4, int8_v=False)

# the c10d functional collectives (and DTensor's all-to-all) by JAX's kind
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute", "recv": "collective-permute",
    "permute_tensor": "collective-permute", "broadcast": "all-gather",
}
# mixers whose step loops over the tokens (the sLSTM recurrence), whose
# eager count runs the loop's ops once a token: see `count_cell`
TOKEN_LOOPS = ("slstm",)
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "_dtensor", "c10d")
# ops that hand a tensor on without moving it: a collective's wait and
# its autograd wrapper
_MOVES_NOTHING = ("wait_tensor", "_wrap_tensor_autograd")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class Counter(TorchDispatchMode):
    """FLOPs, bytes, collective bytes and live temporaries of the ops run
    under it, for this rank (see the module docstring)."""

    def __init__(self, args: Any = ()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collective: Dict[str, float] = {}
        self.ops = 0
        self._known = {_storage(_local(t)) for t in _tensors(args)}
        self._refs: Dict[int, list] = {}        # storage -> [bytes, refs]
        self.live = 0
        self.peak = 0

    def _track(self, t: torch.Tensor) -> None:
        key = _storage(t)
        if key in self._known:
            return
        entry = self._refs.get(key)
        if entry is None:
            entry = self._refs[key] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        entry = self._refs.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._refs[key]

    def _flops(self, func, args, kwargs, out) -> float:
        if func is torch.ops.repro_torch.bitplane_matmul.default:
            x, planes = args[0], args[1]
            return 2.0 * x.shape[0] * x.shape[1] * planes.shape[2]
        formula = flop_registry.get(func._overloadpacket)
        if formula is None:
            return 0.0
        return float(formula(*args, **kwargs, out_val=out))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # a mode runs before DTensor: handing its ops back lets DTensor
        # run them as local ops and the collectives of their
        # redistributes, which come back here on this rank's tensors
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(t.device.type != "meta" for t in outs):
            return out          # DTensor's sharding propagation, not the step
        name = func._overloadpacket.__name__
        self.ops += 1
        if func.namespace in _COLLECTIVE_NS and name in COLLECTIVE_KINDS:
            kind = COLLECTIVE_KINDS[name]
            self.collective[kind] = self.collective.get(kind, 0.0) + sum(
                _nbytes(t) for t in outs)
        elif outs and not func.is_view and name not in _MOVES_NOTHING:
            self.flops += self._flops(func, args, kwargs, out)
            self.bytes += sum(_nbytes(t) for t in
                              _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(t)
        return out


@contextlib.contextmanager
def _card_all_to_all():
    """DTensor's all-to-all as a card issues it.  On a CPU mesh DTensor
    falls back to an all-gather and a chunk (gloo has no all-to-all),
    which would price a Shard-to-Shard move at the group's size times its
    bytes; under the fake group the analysis issues the all-to-all op
    itself, whose shape function runs on the meta tensors."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import placement_types
    if not hasattr(placement_types, "shard_dim_alltoall"):
        yield                           # a torch that does not fall back
        return

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._group_or_group_name(group))
    saved = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = all_to_all
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = saved


@contextlib.contextmanager
def fake_group(world: int):
    """A ``"fake"`` process group of `world` ranks, as rank 0, destroyed
    on exit; refuses to start while a group is running."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is running: the analysis "
                           "starts its own fake group, run it in a "
                           "process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        with _card_all_to_all():
            yield
    finally:
        dist.destroy_process_group()


def _world(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@contextlib.contextmanager
def analysis_mesh(mesh_kind: str = "single", shape=None):
    """The production mesh (``single`` 16x16, ``multi`` 2x16x16) on a fake
    group of its size, or a fake mesh of `shape` (2 or 3 dims)."""
    from torch.distributed.device_mesh import init_device_mesh
    if shape is None:
        shape = (2, 16, 16) if mesh_kind == "multi" else (16, 16)
        with fake_group(_world(shape)):
            yield mesh_mod.make_production_mesh(
                multi_pod=mesh_kind == "multi", device=MESH_DEVICE)
        return
    axes = ("data", "model") if len(shape) == 2 else \
        ("pod", "data", "model")
    with fake_group(_world(shape)):
        yield init_device_mesh(MESH_DEVICE, tuple(shape),
                               mesh_dim_names=axes)


def cell_config(arch: str, quant_bits: Optional[int] = None,
                reduced: bool = False) -> Config:
    """The arch's config, or its reduced one (`models.common.reduced`)."""
    cfg = configs.get(arch, quant_bits=quant_bits)
    return cm.reduced(cfg, quant_bits=quant_bits) if reduced else cfg


def rules_for(arch: str, kind: str) -> Optional[dict]:
    # FSDP archs shard params over (data x model) for every step kind -
    # big models don't fit under pure tensor parallelism even at inference
    st = TRAIN_SETTINGS.get(arch, DEFAULT_TRAIN)
    rules = dict(st.get("rules") or {})
    if st.get("fsdp"):
        base = shd.ShardingConfig(fsdp=True).resolved()
        base.update(rules)
        return base
    return rules or None


def _batch_specs(batch, rules):
    return shd.tree_specs(
        {k: ("batch", "seq") if v.dim() == 2 else ("batch", None, None)
         for k, v in batch.items()}, rules)


def _place_batch(mesh, batch, rules):
    where = shd.shardings_pruned(mesh, _batch_specs(batch, rules), batch)
    return {k: shd.place(v, mesh, where[k]) for k, v in batch.items()}


def build_lowerable(arch: str, shape: str, mesh,
                    quant_bits: Optional[int] = None,
                    cfg: Optional[Config] = None,
                    seq_len: Optional[int] = None
                    ) -> Tuple[Callable, tuple]:
    """(fn, args): the cell's step and its inputs, placed on `mesh` as
    meta tensors by the spec functions under `rules_for`; ``fn(*args)``
    runs the step once.  `cfg` replaces the registry's config (a cut
    depth, a reduced config), `seq_len` the case's length.  On a
    one-rank mesh nothing is placed, as the real steps place nothing
    there."""
    spec = shapes_mod.input_specs(arch, shape, quant_bits=quant_bits,
                                  cfg=cfg, seq_len=seq_len)
    cfg = spec["cfg"]
    kind = spec["kind"]
    rules = rules_for(arch, kind)
    shd.set_mesh_axes(mesh.mesh_dim_names)
    shd.set_active_rules(rules)     # constrain() inside layers follows suit
    st = TRAIN_SETTINGS.get(arch, DEFAULT_TRAIN)
    model = shapes_mod.param_structs(cfg)

    if kind == "train":
        tcfg = train_step_mod.TrainConfig(
            adamw=opt.AdamWConfig(int8_second_moment=st.get("int8_v",
                                                            False)),
            microbatches=st.get("microbatches", 1),
            accum_dtype=st.get("accum", "float32"))
        state = train_step_mod.state_for(model, tcfg)
        fn = train_step_mod.make_jitted_train_step(mesh, cfg, tcfg, rules)
        sspecs = shd.tree_specs(train_step_mod.state_specs(cfg, tcfg),
                                rules)
        batch = spec["batch"]
        if mesh.size() > 1:
            with implicit_replication():
                train_step_mod.place_state(mesh, sspecs, state)
                batch = _place_batch(mesh, batch, rules)
        return fn, (state, batch)

    one = mesh.size() == 1
    if not one:
        shd.place_module(model, mesh, shd.shardings_pruned(
            mesh, shd.tree_specs(lm.specs(cfg), rules), model.state_dict()))

    if kind == "prefill":
        batch = spec["batch"] if one else \
            _place_batch(mesh, spec["batch"], rules)

        def prefill_fn(params, batch):
            with implicit_replication():
                logits, _ = lm.forward(
                    params, batch["tokens"],
                    enc_inputs=batch.get("enc_inputs"),
                    prefix_embeddings=batch.get("prefix_embeddings"),
                    last_only=True)
            return logits
        return prefill_fn, (model, batch)

    # decode
    b = spec["batch"]
    states, tok, ctx = b["states"], b["token"], b.get("ctx")
    if not one:
        where = shd.shardings_pruned(
            mesh, shd.tree_specs(lm.decode_state_specs(cfg), rules), states)
        states = [{k: shd.place(v, mesh, pl[k]) for k, v in st_.items()}
                  for st_, pl in zip(states, where)]
        tok = shd.place(tok, mesh, shd.shardings_pruned(
            mesh, shd.spec_for(("batch", None), rules), tok))
        if ctx is not None:
            ctx = shd.place(ctx, mesh, shd.shardings_pruned(
                mesh, shd.spec_for(("batch", None, None), rules), ctx))

    def decode_fn(params, token, states, index, ctx=None):
        with implicit_replication():
            return lm.decode_step(params, token, states, index, ctx=ctx)
    return decode_fn, (model, tok, states, b["index"], ctx)


def count(fn: Callable, args: tuple) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under a `Counter`; its numbers for this
    rank, and the seconds it took."""
    t0 = time.time()
    inputs = _tensors(_args_tree(args))
    counter = Counter(inputs)
    with counter:
        out = fn(*args)
        out_bytes = sum(_nbytes(_local(t)) for t in _tensors(out)
                        if _storage(_local(t)) not in counter._known)
    arg_bytes = sum(_nbytes(_local(t)) for t in inputs)
    return {"flops": counter.flops, "bytes": counter.bytes,
            "coll": dict(counter.collective), "ops": counter.ops,
            "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "temp_bytes": counter.peak, "seconds": time.time() - t0}


_SUMMED = ("flops", "bytes", "ops", "argument_bytes", "output_bytes",
           "temp_bytes")


def _extrapolate(points, x: float) -> Dict[str, Any]:
    """The counts at `x` of the polynomial through `points`, a list of
    (x_i, `count` result): exact where each count is a polynomial in x of
    degree below the number of points."""
    out: Dict[str, Any] = {"coll": {}}
    for i, (xi, ci) in enumerate(points):
        w = 1.0
        for j, (xj, _) in enumerate(points):
            if j != i:
                w *= (x - xj) / (xi - xj)
        for key in _SUMMED:
            out[key] = out.get(key, 0.0) + w * ci[key]
        for kind, v in ci["coll"].items():
            out["coll"][kind] = out["coll"].get(kind, 0.0) + w * v
    out["seconds"] = sum(c["seconds"] for _, c in points)
    return out


def _loops(cfg: Config, shape: str) -> bool:
    """Whether the cell's step loops over its tokens (`TOKEN_LOOPS`)."""
    return shapes_mod.SHAPES[shape].kind != "decode" and any(
        m in TOKEN_LOOPS for m, _ in cfg.layer_kinds())


def count_cell(arch: str, shape: str, mesh, cfg: Config,
               quant_bits: Optional[int] = None) -> Dict[str, Any]:
    """`count` of the cell's step on `mesh`.  A cell whose step loops
    over its tokens (`_loops`) is counted at three lengths of whole
    mLSTM chunks past the first (`lengths`) and extrapolated to its own
    by the quadratic through them.  That is exact: at those lengths every
    op's size is a polynomial of degree at most two in the length (the
    loop runs once a token, the chunkwise mLSTM once a chunk, and the
    loop's backward writes a gradient of the whole sequence each token);
    temp_bytes is the extrapolated peak."""
    if not _loops(cfg, shape):
        return count(*build_lowerable(arch, shape, mesh, quant_bits, cfg))
    lengths = [k * recurrent.CHUNK for k in (2, 3, 4)]
    out = _extrapolate(
        [(s, count(*build_lowerable(arch, shape, mesh, quant_bits, cfg,
                                    seq_len=s))) for s in lengths],
        shapes_mod.SHAPES[shape].seq_len)
    out["lengths"] = lengths
    return out


def count_periods(arch: str, shape: str, mesh, cfg: Config,
                  quant_bits: Optional[int] = None) -> Dict[str, Any]:
    """`count_cell` of `cfg` cut to one and to two pattern periods,
    extrapolated to its depth: exact for whole periods, which repeat; a
    remainder's layers are priced as a share of a period (the JAX
    roofline's rule)."""
    plen = len(cfg.pattern)
    points = [(n, count_cell(arch, shape, mesh,
                             dataclasses.replace(cfg, n_layers=n * plen),
                             quant_bits)) for n in (1, 2)]
    out = _extrapolate(points, cfg.n_layers / plen)
    out["lengths"] = points[0][1].get("lengths")
    return out


def _args_tree(args):
    """The tensors of the args (an `nn.Module` by its state dict)."""
    out = []
    for a in args:
        if isinstance(a, torch.nn.Module):
            out.append(a.state_dict())
        elif isinstance(a, dict) and "params" in a:
            out.append({**a, "params": a["params"].state_dict()})
        else:
            out.append(a)
    return out


def cell_tag(arch: str, shape: str, mesh_kind: str,
             quant_bits: Optional[int] = None) -> str:
    return f"{arch}__{shape}__{mesh_kind}" + (
        f"__w{quant_bits}" if quant_bits else "")


def run_cell(arch: str, shape: str, mesh_kind: str,
             quant_bits: Optional[int] = None, save: bool = True,
             reduced: bool = False, mesh_shape=None,
             results: str = RESULTS) -> Dict[str, Any]:
    t0 = time.time()
    with analysis_mesh(mesh_kind, mesh_shape) as mesh:
        cfg = cell_config(arch, quant_bits, reduced)
        looped = _loops(cfg, shape)
        c = (count_periods if looped else count_cell)(arch, shape, mesh,
                                                      cfg, quant_bits)
        n_chips = mesh.size()
    counting = "per rank, op level, no fusion"
    if looped:
        counting += (f"; counted at one and two periods and {c['lengths']} "
                     "tokens, extrapolated to the cell's depth and length")
    cost = {"flops": c["flops"], "bytes accessed": c["bytes"],
            "counting": counting}
    result = {
        "arch": arch, "shape": shape, "mesh": mesh_kind,
        "mesh_shape": list(mesh_shape) if mesh_shape else None,
        "reduced": reduced,
        "n_chips": int(n_chips),
        "quant_bits": quant_bits,
        "flops": c["flops"],
        "bytes_accessed": c["bytes"],
        "cost_analysis": cost,
        "memory_analysis": {"argument_bytes": c["argument_bytes"],
                            "output_bytes": c["output_bytes"],
                            "temp_bytes": c["temp_bytes"],
                            "generated_code_bytes": 0},
        "collective_bytes": c["coll"],
        "ops": c["ops"],
        "lower_s": round(time.time() - t0 - c["seconds"], 2),
        "compile_s": round(c["seconds"], 2),
        "ok": True,
    }
    if save:
        d = os.path.join(results, "dryrun")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, cell_tag(arch, shape, mesh_kind,
                                           quant_bits) + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def parse_mesh_shape(text: Optional[str]):
    return tuple(int(v) for v in text.split("x")) if text else None


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=DOC, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--quant", type=int, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh-shape", default=None)
    ap.add_argument("--results", default=RESULTS)
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(a, s) for a, s, skip in shapes_mod.cells() if not skip]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        todo = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in todo:
        for mk in meshes:
            try:
                r = run_cell(arch, shape, mk, quant_bits=args.quant,
                             reduced=args.reduced,
                             mesh_shape=parse_mesh_shape(args.mesh_shape),
                             results=args.results)
                print(f"OK  {arch:18s} {shape:12s} {mk:6s} "
                      f"flops={r['flops']:.3e} "
                      f"coll={sum(r['collective_bytes'].values()):.3e}B "
                      f"compile={r['compile_s']}s", flush=True)
                print("  memory:", r["memory_analysis"], flush=True)
            except Exception as e:   # report the cell, go on to the next
                failures += 1
                print(f"FAIL {arch} {shape} {mk}: {type(e).__name__}: "
                      f"{str(e)[:300]}", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
