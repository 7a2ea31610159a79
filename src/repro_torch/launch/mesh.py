"""Mesh builders: `torch.distributed` device meshes over the ranks of the
running process group.

The port of `repro.launch.mesh`.  Functions, not module-level
constants: importing this module starts no process group.  A rank is a
process with one device (NCCL takes one rank a card), so the JAX
package's device count is the world size here.
"""
from __future__ import annotations

import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models import common as cm


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ensure_group(device) -> None:
    """Start a one-rank group (NCCL on `device`'s card, gloo on the CPU)
    on a localhost port the OS picks, unless a group is running."""
    if dist.is_initialized():
        return
    backend = "gloo"
    if device.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(backend,
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks);
    raises unless the running group has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 1
    for s in shape:
        want *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != want:
        raise RuntimeError(f"the production mesh {shape} needs a process "
                           f"group of {want} ranks, one a device; the "
                           f"running group has {have}")
    return init_device_mesh(cm.device(device).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(device="cuda") -> DeviceMesh:
    """Whatever the running group offers, as (data, model): the model
    axis takes 4, 2 or 1 ranks, the first that divides the world size.
    Without a running group it starts a one-rank one, so one card gives
    a (1, 1) mesh.  `device` defaults to cuda and raises without one."""
    dev = cm.device(device)
    _ensure_group(dev)
    n = dist.get_world_size()
    model = next(m for m in (4, 2, 1) if n % m == 0)
    return init_device_mesh(dev.type, (n // model, model),
                            mesh_dim_names=("data", "model"))
