"""Pipeline parallelism with the GPipe schedule over a mesh axis (twin of
``repro.parallel.pipeline``) on ``torch.distributed``.

Each rank of the ``axis`` dim of the mesh holds one stage.  The schedule
runs ``n_micro + n_stages - 1`` ticks: at each tick every rank applies
its stage to the activation it holds, and the ring advances one hop
(``batch_isend_irecv``: rank i sends to i + 1), so compute and
communication overlap across ranks; bubble fraction = (n_stages - 1) /
(n_micro + n_stages - 1).  Rank 0 takes microbatch t at tick t (zeros
once the stream runs dry); the last rank's outputs from tick
n_stages - 1 on are the results, and a SUM all-reduce over the axis (the
other ranks contribute zeros) gives every rank all of them, as the
reference's ``psum`` does.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.tree import tree_map

__all__ = ["gpipe_apply", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _stage_slice(leaf, rank: int):
    """This rank's stage of a (n_stages, ...) leaf: a plain tensor is
    indexed by the rank; a DTensor sharded over the axis holds it."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        local = leaf.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"gpipe_apply: a stage-sharded leaf must hold "
                             f"one stage a rank, got {local.shape[0]}")
        return local[0]
    return leaf[rank]


def gpipe_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                mesh, axis: str = "pod") -> torch.Tensor:
    """Run ``x`` through the pipeline.

    stage_fn(params_slice, h) -> h          (one stage, shapes preserved)
    stage_params: tree of (n_stages, ...) leaves, held whole by every rank
      or as DTensors sharded over ``axis`` on dim 0
    x: (n_micro, mb, ...) microbatched input, the same on every rank
    Returns (n_micro, mb, ...) outputs, the same on every rank.
    """
    import torch.distributed as dist
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    rank = dist.get_rank(group)
    last = n_stages - 1
    n_micro = x.shape[0]
    params = tree_map(lambda a: _stage_slice(a, rank), stage_params)
    buf = torch.zeros_like(x[0])
    emits = []
    for t in range(n_micro + n_stages - 1):
        if rank == 0:
            buf = x[t] if t < n_micro else torch.zeros_like(x[0])
        y = stage_fn(params, buf).contiguous()
        emits.append(y if rank == last else torch.zeros_like(y))
        ops = []
        recv = torch.zeros_like(y)
        if rank < last:
            ops.append(dist.P2POp(dist.isend, y,
                                  dist.get_global_rank(group, rank + 1),
                                  group))
        if rank > 0:
            ops.append(dist.P2POp(dist.irecv, recv,
                                  dist.get_global_rank(group, rank - 1),
                                  group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        buf = recv
    out = torch.stack(emits[last:])
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out
