"""Fault-tolerant training loop: checkpoint/restart and a straggler
watchdog.

The port of `repro.train.loop`, on one device or on a mesh of ranks:

  * auto-resume: on start, restore the newest valid checkpoint (manifest
    checksums guard torn writes) and continue from its step; the data
    pipeline is stateless-by-step so no batches are lost or repeated;
  * elastic: checkpoints hold whole arrays, and a `Trainer` given a mesh
    restores them onto that mesh's placements, whatever mesh wrote them;
  * async checkpointing every `ckpt_every` steps off the critical path,
    and a final blocking save of the last step;
  * straggler watchdog: each step's wall time, taken once its loss is on
    the host, is held against the rolling median of the last 20 steps;
    a step slower than `straggler_factor` x that median raises a counter
    that operators alert on.

Under a running group every rank runs the loop; the watchdog's and the
log's lines print on rank 0 only.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..checkpoint.manager import CheckpointManager
from ..data.pipeline import SyntheticLM
from ..models import common as cm
from ..models.common import Config
from ..parallel import sharding as shd
from . import step as step_mod


def host_float(x: torch.Tensor) -> float:
    """A scalar metric on the host; a `DTensor` is gathered (every rank
    calls this)."""
    return float(x.full_tensor() if isinstance(x, DTensor) else x)


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_last: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


class Trainer:
    """`step_fn(state, batch) -> (state, metrics)` defaults to
    `step.train_step`, or, given a `mesh` (a `DeviceMesh`), to
    `step.make_jitted_train_step(mesh, cfg, tcfg, rules)`; the state
    lives on `device` (``cuda`` unless the caller asks for the CPU), and
    on a mesh of many ranks it is placed by `step.state_specs` under
    `rules`."""

    def __init__(self, cfg: Config, tcfg: step_mod.TrainConfig,
                 lcfg: LoopConfig, data: SyntheticLM, mesh=None,
                 rules: Optional[dict] = None,
                 step_fn: Optional[Callable] = None, device="cuda"):
        self.cfg, self.tcfg, self.lcfg, self.data = cfg, tcfg, lcfg, data
        self.mesh, self.rules, self.device = mesh, rules, device
        self.ckpt = CheckpointManager(lcfg.ckpt_dir, keep_last=lcfg.keep_last)
        if step_fn is not None:
            self.step_fn = step_fn
        elif mesh is not None:
            self.step_fn = step_mod.make_jitted_train_step(mesh, cfg, tcfg,
                                                           rules)
        else:
            self.step_fn = lambda s, b: step_mod.train_step(s, b, cfg, tcfg)
        self.step_times: list = []
        self.straggler_events = 0

    def shardings(self, state: Dict[str, Any]) -> Any:
        """The placement tree of `state` on the trainer's mesh (the
        `shardings` of `CheckpointManager.restore`)."""
        sspecs = shd.tree_specs(step_mod.state_specs(self.cfg, self.tcfg),
                                self.rules)
        struct = {"params": state["params"].state_dict(),
                  "opt": state["opt"], "step": state["step"]}
        return shd.shardings_pruned(self.mesh, sspecs, struct)

    def init_or_restore(self, seed: int = 0) -> Dict[str, Any]:
        dev = cm.device(self.device)
        state = step_mod.init_state(
            torch.Generator(device=dev).manual_seed(seed), self.cfg,
            self.tcfg, dev)
        where = None if self.mesh is None else self.shardings(state)
        try:
            state, step = self.ckpt.restore(state, shardings=where,
                                            mesh=self.mesh)
            if _rank0():
                print(f"[trainer] resumed from step {step}", flush=True)
        except FileNotFoundError:
            pass
        return state

    def run(self, state: Dict[str, Any],
            on_step: Optional[Callable] = None) -> Dict[str, Any]:
        start = int(host_float(state["step"]))
        for step in range(start, self.lcfg.total_steps):
            batch = self.data.batch_at(step)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            loss = host_float(metrics["loss"])        # waits for the step
            dt = time.perf_counter() - t0
            # straggler watchdog (vs rolling median of last 20 steps)
            if len(self.step_times) >= 5:
                med = statistics.median(self.step_times[-20:])
                if dt > self.lcfg.straggler_factor * med:
                    self.straggler_events += 1
                    if _rank0():
                        print(f"[watchdog] step {step} took {dt:.3f}s "
                              f"(median {med:.3f}s)", flush=True)
            self.step_times.append(dt)
            # the last step's checkpoint is the final blocking save below
            # (the JAX loop writes it twice)
            if (step + 1) % self.lcfg.ckpt_every == 0 and \
                    step + 1 < self.lcfg.total_steps:
                self.ckpt.save(step + 1, state, blocking=False)
            if on_step is not None:
                on_step(step, state, metrics)
            if (step + 1) % self.lcfg.log_every == 0:
                gnorm = host_float(metrics["grad_norm"])
                if _rank0():
                    print(f"[trainer] step {step + 1} loss={loss:.4f} "
                          f"gnorm={gnorm:.3f} dt={dt * 1e3:.0f}ms",
                          flush=True)
        self.ckpt.wait()
        self.ckpt.save(self.lcfg.total_steps, state, blocking=True)
        return state
