"""Deterministic synthetic LM data pipeline.

The port of `repro.data.pipeline`, in numpy: `batch_at(step)` derives
every batch from (seed, step) alone, by the JAX package's own numpy
draws, so its tokens and labels are byte for byte the JAX pipeline's and
checkpoint/restore never loses or repeats data - the "pipeline state" is
the integer step, which rides inside the train checkpoint.

The token stream is a two-level Markov process over a Zipf vocabulary, so
the loss has learnable structure and decreases within a few hundred
steps.  Batches are int32 tensors on the CPU; the trainer moves each to
the model's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 1234
    zipf_a: float = 1.2
    n_states: int = 32             # hidden Markov states


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v, k = cfg.vocab, cfg.n_states
        # per-state token distribution: sharpened shifted-Zipf slices, so
        # each hidden state emits from a concentrated vocabulary region
        # (gives the stream strong, learnable n-gram structure)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        base = 3.0 * np.log(1.0 / ranks ** cfg.zipf_a)
        self._emit_logits = np.stack([
            np.roll(base, rng.integers(0, v)) for _ in range(k)
        ]).astype(np.float32)
        trans = rng.dirichlet(np.full(k, 0.25), size=k).astype(np.float32)
        self._trans_logits = np.log(trans + 1e-9)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Fully deterministic batch for a given step: int32 tensors
        [global_batch, seq_len] on the CPU; the labels are
        the tokens shifted left by one, with -1 at the last position of
        every row."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s, k = cfg.global_batch, cfg.seq_len, cfg.n_states
        states = np.zeros((b, s), np.int64)
        states[:, 0] = rng.integers(0, k, size=b)
        trans = np.exp(self._trans_logits)
        trans /= trans.sum(1, keepdims=True)
        # vectorized Markov walk via inverse-CDF sampling
        cdf = np.cumsum(trans, axis=1)
        u = rng.random((b, s))
        for t in range(1, s):
            states[:, t] = (u[:, t:t + 1] > cdf[states[:, t - 1]]).sum(1)
        emit = np.exp(self._emit_logits
                      - self._emit_logits.max(1, keepdims=True))
        emit /= emit.sum(1, keepdims=True)
        ecdf = np.cumsum(emit, axis=1)
        ue = rng.random((b, s))
        tokens = np.zeros((b, s), np.int32)
        # chunked searchsorted per state
        for st in range(k):
            m = states == st
            if m.any():
                tokens[m] = np.searchsorted(ecdf[st], ue[m]).astype(np.int32)
        tokens = np.clip(tokens, 0, cfg.vocab - 1)
        labels = np.concatenate([tokens[:, 1:], tokens[:, :1] * 0 - 1],
                                axis=1).astype(np.int32)
        return {"tokens": torch.from_numpy(tokens),
                "labels": torch.from_numpy(labels)}

    def iterate(self, start_step: int = 0
                ) -> Iterator[Dict[str, torch.Tensor]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def input_sharding(mesh, rules: Optional[dict] = None):
    """The batch's `DTensor` placements on `mesh`: tokens and labels
    sharded along the batch by the ``batch`` rule."""
    from ..parallel import sharding as shd
    return shd.shardings(mesh, shd.tree_specs(
        {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}, rules))
