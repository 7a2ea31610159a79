"""Launch counts of the kernels a decode step runs, kept true for steps
replayed from a CUDA graph.

Each such kernel's wrapper `register`s how it counts its launches (its
module's ``launches``, and any metric of its own) and reports each launch
through `launched`.  A call recorded into a CUDA graph launches nothing:
inside `recording()` launches are tallied instead of counted, and `add`
counts a tally once for each replay.  So `lm.DecodeGraph` counts its
replays as the eager step's wrappers would, naming no kernel.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional

_COUNTS: Dict[str, Callable[[int], None]] = {}
_tally: Optional[Dict[str, int]] = None


def register(name: str, count: Callable[[int], None]) -> None:
    """`count(n)` adds n launches of kernel `name` where its wrapper keeps
    them."""
    _COUNTS[name] = count


def launched(name: str) -> None:
    """One launch of `name`: counted, or tallied inside `recording()`."""
    if _tally is None:
        _COUNTS[name](1)
    else:
        _tally[name] = _tally.get(name, 0) + 1


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Tally, rather than count, the launches made inside; yields the
    tally ({kernel name: launches}), complete once the block ends."""
    global _tally
    prev, _tally = _tally, {}
    try:
        yield _tally
    finally:
        _tally = prev


def add(tally: Dict[str, int]) -> None:
    """Count a recording's tally once (one replay of its graph)."""
    for name, n in tally.items():
        _COUNTS[name](n)
