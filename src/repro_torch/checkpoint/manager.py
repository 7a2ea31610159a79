"""Fault-tolerant checkpointing: a manifest and one raw-bytes shard per
leaf, async save, newest-valid restore.

The port of `repro.checkpoint.manager`, in the JAX package's on-disk
format, so that each package reads the other's directories:

  * ``step_<10 digits>/`` holds ``shard_<5 digits>.bin`` (a leaf's raw
    bytes, C order) for each leaf and ``manifest.json`` (``step``,
    ``time`` and per leaf ``name``, ``file``, ``sha256``, ``shape`` and
    ``dtype``), written last, into ``.tmp`` and published by an atomic
    rename - a torn save is never the newest valid one;
  * a bf16 leaf is written as its 16-bit patterns with the dtype
    ``"bfloat16"``, as the JAX manifest names it (no `ml_dtypes` needed);
  * saves can run on a background thread: the state is copied to host
    memory first, so the next step's in-place update cannot race the
    writer;
  * ``keep_last`` bounds disk use; restore falls back to older
    checkpoints when the newest fails its checksums.

A tree is a dict (nested dicts, `nn.Module`s, tensors); its leaves, in
order, are a dict's values in insertion order and a module's state-dict
entries, named by their dotted paths (``params.embed.e``,
``opt.embed.e.m``, ``step``).  Restore matches leaves by position, as the
JAX manager does, and writes each into the matching tensor of `like` in
place.

Across ranks (a running `torch.distributed` group), files hold whole
arrays, as the JAX manager's do:

  * every rank calls `save` with its part of the same state: each
    `DTensor` leaf is gathered (``full_tensor()``, a collective, so every
    rank takes part), rank 0 alone writes, and the others wait for it on
    a barrier before `save` returns (an async save: before its `wait`
    returns).  The files are byte for byte those one process writes from
    the same values;
  * ``restore(like, shardings=...)`` is the elastic re-shard: every rank
    reads each leaf whole and keeps the shard its placements give it, on
    whatever mesh the new job built, whatever mesh wrote the files.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Placement, distribute_tensor

MANIFEST = "manifest.json"


def _module_put(module: nn.Module, key: str) -> Callable:
    """A setter of state-dict entry `key` of `module`: a param stays a
    param (with its ``requires_grad``), a buffer a buffer."""
    def put(new: torch.Tensor) -> None:
        owner_name, _, leaf = key.rpartition(".")
        owner = module.get_submodule(owner_name)
        old = getattr(owner, leaf)
        if isinstance(old, nn.Parameter):
            setattr(owner, leaf, nn.Parameter(
                new, requires_grad=old.requires_grad))
        else:
            owner.register_buffer(leaf, new)
    return put


def _slots(tree: Any, prefix: str = ""
           ) -> List[Tuple[str, torch.Tensor, Optional[Callable]]]:
    """(name, tensor, setter) of every leaf of `tree`, in checkpoint
    order; the setter replaces the leaf (None for a bare tensor)."""
    if isinstance(tree, nn.Module):
        return [(prefix + k, t, _module_put(tree, k))
                for k, t in tree.state_dict().items()]
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                out.append((f"{prefix}{k}", v,
                            lambda new, d=tree, k=k: d.__setitem__(k, new)))
            else:
                out += _slots(v, f"{prefix}{k}.")
        return out
    if isinstance(tree, torch.Tensor):
        return [(prefix[:-1], tree, None)]
    raise TypeError(f"{prefix[:-1] or 'tree'}: cannot checkpoint "
                    f"{type(tree).__name__}")


def leaves(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf of `tree`, in checkpoint order."""
    return [(n, t) for n, t, _ in _slots(tree, prefix)]


def _is_placements(x) -> bool:
    return isinstance(x, tuple) and bool(x) and all(
        isinstance(p, Placement) for p in x)


def _flat_placements(tree: Any, prefix: str = "") -> Dict[str, tuple]:
    """A placement tree (nested dicts whose leaves are `DTensor`
    placements, as `parallel.sharding.shardings` gives them) by dotted
    leaf name, the names `leaves` gives."""
    if _is_placements(tree):
        return {prefix[:-1]: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_placements(v, f"{prefix}{k}."))
        return out
    raise TypeError(f"{prefix[:-1] or 'shardings'}: not a placement tree "
                    f"node: {type(tree).__name__}")


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    """Every rank of the running group meets here (nothing without one,
    or with one rank)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of `t` as a numpy array, and the dtype to record; a
    `DTensor` is gathered whole first (a collective: the other ranks
    meet it in `_gather_only`)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _gather_only(tree: Any) -> None:
    """A rank that does not write takes part in each leaf's gather, in
    `_host`'s order, and keeps nothing."""
    for _, t in leaves(tree):
        if isinstance(t, DTensor):
            t.full_tensor()


def _from_bytes(buf: bytearray, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.frombuffer(buf, np.int16)).view(
            torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(buf, np.dtype(dtype))).reshape(
        shape)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False         # an async save's barrier is owed

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True) -> str:
        """Write `tree` as step `step`.  Under a running group every rank
        calls this: all gather, rank 0 alone keeps a host copy and
        writes, the others wait for it on a barrier (here, or for an
        async save in `wait`)."""
        writer = _rank() == 0
        if writer:
            host = [(name, *_host(t)) for name, t in leaves(tree)]
        else:
            _gather_only(tree)
        if blocking:
            d = self._save_sync(step, host) if writer else \
                self._step_dir(step)
            _barrier()
            return d
        self.wait()
        if writer:
            self._thread = threading.Thread(
                target=self._save_async, args=(step, host), daemon=True)
            self._thread.start()
        self._pending = True
        return self._step_dir(step)

    def wait(self):
        """Join the running async save (every rank meets rank 0 there
        once it has written); re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            _barrier()
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _save_async(self, step: int, host):
        try:
            self._save_sync(step, host)
        except BaseException as e:        # handed to wait(), re-raised
            self._error = e

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _save_sync(self, step: int, host) -> str:
        d = self._step_dir(step)
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        index = []
        for i, (name, arr, dtype) in enumerate(host):
            fname = f"shard_{i:05d}.bin"
            data = arr.reshape(-1).view(np.uint8)
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(data)
            index.append({"name": name, "file": fname,
                          "sha256": hashlib.sha256(data).hexdigest(),
                          "shape": list(arr.shape), "dtype": dtype})
        manifest = {"step": step, "time": time.time(), "leaves": index}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)                      # atomic publish
        self._gc()
        return d

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self):
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_") and not n.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, n, MANIFEST)):
                    out.append(int(n.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _validate(self, d: str) -> bool:
        try:
            with open(os.path.join(d, MANIFEST)) as f:
                manifest = json.load(f)
            for entry in manifest["leaves"]:
                with open(os.path.join(d, entry["file"]), "rb") as f:
                    if hashlib.sha256(f.read()).hexdigest() != \
                            entry["sha256"]:
                        return False
            return True
        except (OSError, json.JSONDecodeError, KeyError):
            return False

    @torch.no_grad()
    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None, mesh=None) -> Tuple[Any, int]:
        """Restore into the tensors of `like`, in place, from the newest
        *valid* checkpoint (or `step`); returns (like, step).  A leaf
        whose shape or dtype differs from its tensor's raises ValueError;
        no valid checkpoint raises FileNotFoundError.

        `shardings` (the placement tree of `parallel.sharding.shardings`
        or `shardings_pruned` on the new mesh, with `like`'s structure)
        re-shards onto the new topology, the JAX manager's elastic
        restore: every rank reads each leaf whole and keeps its own
        shard.  A `DTensor` leaf of `like` takes its shard in place, or
        is replaced by a `DTensor` of the new placements on its own mesh;
        a plain leaf is replaced by a `DTensor` on `mesh` where `mesh`
        has more than one rank, and otherwise (one rank: a shard is the
        whole array) takes the whole array in place."""
        steps = self.all_steps() if step is None else [step]
        for s in reversed(steps):
            d = self._step_dir(s)
            if not self._validate(d):
                continue
            with open(os.path.join(d, MANIFEST)) as f:
                manifest = json.load(f)
            named = _slots(like)
            entries = manifest["leaves"]
            if len(entries) != len(named):
                raise ValueError(f"{d}: {len(entries)} leaves, the state "
                                 f"has {len(named)}")
            where = None if shardings is None else \
                _flat_placements(shardings)
            for e, (name, t, put) in zip(entries, named):
                path = os.path.join(d, e["file"])
                buf = bytearray(os.path.getsize(path))
                with open(path, "rb") as f:
                    f.readinto(buf)
                arr = _from_bytes(buf, e["dtype"], e["shape"])
                if arr.shape != t.shape or arr.dtype != t.dtype:
                    raise ValueError(
                        f"{name}: checkpoint leaf {e['name']} is "
                        f"{e['dtype']} {e['shape']}, the state's "
                        f"{t.dtype} {list(t.shape)}")
                if where is None:
                    t.copy_(arr)
                    continue
                if name not in where:
                    raise ValueError(f"shardings has no placements for "
                                     f"{name}")
                _put_placed(name, t, put, arr, where[name], mesh)
            return like, manifest["step"]
        raise FileNotFoundError(f"no valid checkpoint under {self.dir}")


def _put_placed(name: str, t: torch.Tensor, put: Optional[Callable],
                arr: torch.Tensor, where: tuple, mesh) -> None:
    """Write the whole array `arr` into leaf `t` as placements `where`
    give it: each rank keeps its own shard, cut locally (every rank holds
    the whole array, so no collective is needed)."""
    if isinstance(t, DTensor):
        new = distribute_tensor(arr.to(t.to_local().device), t.device_mesh,
                                where, src_data_rank=None)
        if tuple(t.placements) == tuple(where):
            t.to_local().copy_(new.to_local())
            return
    elif mesh is not None and mesh.size() > 1:
        new = distribute_tensor(arr.to(t.device), mesh, where,
                                src_data_rank=None)
    else:
        t.copy_(arr)
        return
    if put is None:
        raise ValueError(f"{name}: a bare tensor cannot be re-placed")
    put(new)
