"""int8 gradient compression with error feedback (twin of
``repro.parallel.compression``) on ``torch.distributed``.

Scheme (per leaf), as in the reference:

  scale  = max|g| / 127          (one f32 per leaf)
  q      = round(g / scale) : int8   (round half to even in both packages)
  wire   = all_reduce(int32(q))  -- the int8 values cross the link
           widened to int32, 4 bytes an element (no fewer than f32), as
           in the reference (a psum of int32)
  g_hat  = q * scale ; residual = g - dequant(q)  (error feedback, added
           to the *next* step's gradient so quantisation error is not lost)

:func:`compress_decompress` is the quantise + error-feedback core over the
port's trees (:mod:`repro_torch.tree`); :class:`ErrorFeedback` carries its
residuals from step to step as a ``grad_transform`` of
:func:`repro_torch.train.make_train_step`.  :func:`int8_psum` is the
collective: every rank agrees on ONE scale (an all-reduce MAX of |x|,
one f32 scalar), the int8 values are summed as int32 (an all-reduce SUM)
and divided by the group's size, so the sum dequantises exactly.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["quantize", "dequantize", "compress_decompress", "int8_psum",
           "init_residuals", "ErrorFeedback"]


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 0-d) of ``g``."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_residuals(grads) -> Any:
    """Zero f32 residuals in the structure of ``grads``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress_decompress(grads, residuals) -> Tuple[Any, Any]:
    """Quantise grads (+ the carried residual); return (g_hat,
    new_residuals), g_hat in each gradient's dtype.

    Simulates the int8 wire format end to end; across ranks the sum runs
    between quantize and dequantize (see :func:`int8_psum`)."""
    def one(g, r):
        gf = g.float() + r
        q, scale = quantize(gf)
        g_hat = dequantize(q, scale)
        return g_hat.to(g.dtype), gf - g_hat

    out = [one(g, r) for g, r in zip(leaves(grads), leaves(residuals))]
    g_hat, new_r = iter([a for a, _ in out]), iter([b for _, b in out])
    return (tree_map(lambda _: next(g_hat), grads),
            tree_map(lambda _: next(new_r), grads))


class ErrorFeedback:
    """``grad_transform`` for :func:`repro_torch.train.make_train_step`:
    each call compresses the gradient tree with the residuals the last
    call left (zero at first) and keeps the new ones."""

    def __init__(self):
        self.residuals = None

    def __call__(self, grads):
        if self.residuals is None:
            self.residuals = init_residuals(grads)
        g_hat, self.residuals = compress_decompress(grads, self.residuals)
        return g_hat


def int8_psum(x: torch.Tensor, group: Optional[Any] = None) -> torch.Tensor:
    """Mean all-reduce of ``x`` over ``group`` (default the world) of
    int8-quantised values: ranks agree on one scale (all-reduce MAX of
    max|x|), sum their int8 values as int32 (the all-reduce moves int32,
    4 bytes an element) and divide by the group's size.  Returns the mean
    in ``x``'s dtype."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    xf = x.float()
    amax = xf.abs().max().reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax[0] / 127.0, min=1e-30)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    return (qsum.float() * scale / n).to(x.dtype)
