"""The one traffic generator: it reads a mix's parameters from its data
file (`bench/traffic/<name>.json`) and draws the requests of a run.

A mix is a closed loop over the server's slots: every request is queued
at the start of the window, and a slot takes the next one as soon as its
request retires.  The window is a fixed amount of work,
``round(requests_per_s * seconds)`` requests, sized from the rate the
cell served when it was defined, so that it lasts about `seconds`.

Prompt and output lengths are log-normal, fitted to a published trace's
median and mean (``"dist": "lognormal"``: mu = ln(median), sigma =
sqrt(2 ln(mean / median))), multiplied by the mix's ``scale`` (the cut
a run's length forces, stated in the mix's ``cut``), rounded and
clipped to [min, max].  The lengths and their order are drawn once from
the mix's own ``size_seed``, the same for every seed; the run's seed
draws the prompt tokens.  So every seed runs the same schedule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Req:
    prompt: np.ndarray         # int64 token ids, at least one
    steps: int                 # tokens to emit


def _lengths(rng: np.random.Generator, n: int, dist: dict,
             scale: float) -> np.ndarray:
    """n integer lengths in [min, max] from `dist`."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    median, mean = float(dist["median"]), float(dist["mean"])
    sigma = math.sqrt(2.0 * math.log(mean / median))
    x = rng.lognormal(math.log(median), sigma, size=n) * scale
    return np.clip(np.rint(x), int(dist["min"]),
                   int(dist["max"])).astype(np.int64)


def request_count(mix: dict, seconds: float) -> int:
    return max(int(mix["slots"]), int(round(mix["requests_per_s"] * seconds)))


def sizes(mix: dict, n: int) -> np.ndarray:
    """[n, 2] (prompt, output) lengths in the order they are queued: the
    mix's fixed list for n requests, the same for every seed."""
    rng = np.random.default_rng(int(mix["size_seed"]))
    scale = float(mix["scale"])
    p = _lengths(rng, n, mix["prompt_len"], scale)
    s = _lengths(rng, n, mix["output_len"], scale)
    if (p + s > int(mix["max_len"])).any():
        raise ValueError("a request of the mix exceeds its max_len")
    return np.stack([p, s], axis=1)


def requests(mix: dict, seed: int, seconds: float, vocab: int) -> List[Req]:
    """The run's requests, in the order the server takes them."""
    ps = sizes(mix, request_count(mix, seconds))
    rng = np.random.default_rng([int(seed), 0x7af1c])
    return [Req(rng.integers(0, vocab, size=int(p)), int(s)) for p, s in ps]


def warmup_requests(mix: dict, vocab: int) -> List[Req]:
    """A short mix that runs every shape the window runs: each slot busy,
    then retiring one by one, so that the last steps run with fewer live
    slots, as the window's drain does."""
    slots = int(mix["slots"])
    return [Req(np.arange(2, dtype=np.int64) % vocab, 1 + g % 4)
            for g in range(slots)]
