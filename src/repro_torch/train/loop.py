"""Fault-tolerant training loop: checkpoint/restart and a straggler
watchdog.

The port of `repro.train.loop` on one device:

  * auto-resume: on start, restore the newest valid checkpoint (manifest
    checksums guard torn writes) and continue from its step; the data
    pipeline is stateless-by-step so no batches are lost or repeated;
  * async checkpointing every `ckpt_every` steps off the critical path,
    and a final blocking save of the last step;
  * straggler watchdog: each step's wall time, taken once its loss is on
    the host, is held against the rolling median of the last 20 steps;
    a step slower than `straggler_factor` x that median raises a counter
    that operators alert on.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..checkpoint.manager import CheckpointManager
from ..data.pipeline import SyntheticLM
from ..models import common as cm
from ..models.common import Config
from . import step as step_mod


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
    `step.train_step`; the state lives on `device` (``cuda`` unless the
    caller asks for the CPU)."""

    def __init__(self, cfg: Config, tcfg: step_mod.TrainConfig,
                 lcfg: LoopConfig, data: SyntheticLM,
                 step_fn: Optional[Callable] = None, device="cuda"):
        self.cfg, self.tcfg, self.lcfg, self.data = cfg, tcfg, lcfg, data
        self.device = device
        self.ckpt = CheckpointManager(lcfg.ckpt_dir, keep_last=lcfg.keep_last)
        self.step_fn = step_fn or (
            lambda s, b: step_mod.train_step(s, b, cfg, tcfg))
        self.step_times: list = []
        self.straggler_events = 0

    def init_or_restore(self, seed: int = 0) -> Dict[str, Any]:
        dev = cm.device(self.device)
        state = step_mod.init_state(
            torch.Generator(device=dev).manual_seed(seed), self.cfg,
            self.tcfg, dev)
        try:
            state, step = self.ckpt.restore(state)
            print(f"[trainer] resumed from step {step}", flush=True)
        except FileNotFoundError:
            pass
        return state

    def run(self, state: Dict[str, Any],
            on_step: Optional[Callable] = None) -> Dict[str, Any]:
        start = int(state["step"])
        for step in range(start, self.lcfg.total_steps):
            batch = self.data.batch_at(step)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])        # waits for the step
            dt = time.perf_counter() - t0
            # straggler watchdog (vs rolling median of last 20 steps)
            if len(self.step_times) >= 5:
                med = statistics.median(self.step_times[-20:])
                if dt > self.lcfg.straggler_factor * med:
                    self.straggler_events += 1
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
                print(f"[trainer] step {step + 1} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"dt={dt * 1e3:.0f}ms", flush=True)
        self.ckpt.wait()
        self.ckpt.save(self.lcfg.total_steps, state, blocking=True)
        return state
