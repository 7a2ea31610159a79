"""Pipeline parallelism: microbatch pipelining over a `stage` group.

The port of `repro.parallel.pipeline`: a GPipe schedule.  The layer
stack is split into S stages, one a rank of the stage process group; a
buffer carries microbatch activations from stage to stage around a ring
(the JAX ``ppermute``, here `dist.isend`/`dist.irecv` to rank + 1).
With M microbatches the bubble fraction is (S-1)/(M+S-1).  The last
stage holds the finished microbatches and every other stage zeros, so an
all-reduce sum shares the result, as the JAX ``psum`` does.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _stage_slice(params: Any, stage: int) -> Any:
    if isinstance(params, dict):
        return {k: _stage_slice(v, stage) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_stage_slice(v, stage) for v in params)
    return params[stage]


def pipelined_apply(fn: Callable,
                    group: Optional[dist.ProcessGroup] = None) -> Callable:
    """Build a pipelined forward: y = fn_S(...fn_1(x)) over the ranks of
    `group` (None: the default group), stage s on the group's rank s.

    fn(stage_params, x) -> x is the per-stage computation.  The returned
    function takes (params, x): x [n_micro, mb, ...], the same on every
    rank; params a tensor, or nested dicts and lists of tensors, each
    with a leading stage dim, of which each rank applies its own slice.
    It returns y [n_micro, mb, ...] on every rank.
    """
    def run(params, x: torch.Tensor) -> torch.Tensor:
        n_stages = dist.get_world_size(group)
        stage = dist.get_rank(group)
        nxt = dist.get_global_rank(group, (stage + 1) % n_stages) \
            if group is not None else (stage + 1) % n_stages
        prv = dist.get_global_rank(group, (stage - 1) % n_stages) \
            if group is not None else (stage - 1) % n_stages
        sp = _stage_slice(params, stage)
        n_micro = x.shape[0]
        buf = torch.zeros_like(x[0])
        outs = torch.zeros_like(x)
        for t in range(n_micro + n_stages - 1):
            # t-th tick: stage s works on microbatch t-s (if valid)
            mb = t - stage
            valid = 0 <= mb < n_micro
            inp = x[min(max(mb, 0), n_micro - 1)] if stage == 0 else buf
            out = fn(sp, inp) if valid else torch.zeros_like(buf)
            # pass to the next stage around the ring
            if n_stages > 1:
                buf = torch.empty_like(buf)
                for req in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, out.contiguous(), nxt, group),
                        dist.P2POp(dist.irecv, buf, prv, group)]):
                    req.wait()
            else:
                buf = out
            # last stage records its finished microbatch
            if valid and stage == n_stages - 1:
                outs[mb] = out
        # every stage holds zeros except the last; share the result
        dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
        return outs

    return run
