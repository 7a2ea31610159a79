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
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

MANIFEST = "manifest.json"


def leaves(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf of `tree`, in checkpoint order."""
    if isinstance(tree, nn.Module):
        return [(prefix + k, t) for k, t in tree.state_dict().items()]
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += leaves(v, f"{prefix}{k}.")
        return out
    if isinstance(tree, torch.Tensor):
        return [(prefix[:-1], tree)]
    raise TypeError(f"{prefix[:-1] or 'tree'}: cannot checkpoint "
                    f"{type(tree).__name__}")


def _host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of `t` as a numpy array, and the dtype to record."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


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

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True) -> str:
        host = [(name, *_host(t)) for name, t in leaves(tree)]
        if blocking:
            return self._save_sync(step, host)
        self.wait()
        self._thread = threading.Thread(
            target=self._save_async, args=(step, host), daemon=True)
        self._thread.start()
        return self._step_dir(step)

    def wait(self):
        """Join the running async save; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
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
    def restore(self, like: Any, step: Optional[int] = None
                ) -> Tuple[Any, int]:
        """Restore into the tensors of `like`, in place, from the newest
        *valid* checkpoint (or `step`); returns (like, step).  A leaf
        whose shape or dtype differs from its tensor's raises ValueError;
        no valid checkpoint raises FileNotFoundError."""
        steps = self.all_steps() if step is None else [step]
        for s in reversed(steps):
            d = self._step_dir(s)
            if not self._validate(d):
                continue
            with open(os.path.join(d, MANIFEST)) as f:
                manifest = json.load(f)
            named = leaves(like)
            entries = manifest["leaves"]
            if len(entries) != len(named):
                raise ValueError(f"{d}: {len(entries)} leaves, the state "
                                 f"has {len(named)}")
            for e, (name, t) in zip(entries, named):
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
                t.copy_(arr)
            return like, manifest["step"]
        raise FileNotFoundError(f"no valid checkpoint under {self.dir}")
