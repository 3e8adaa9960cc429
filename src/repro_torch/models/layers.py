"""Layer primitives: matmul, norms, RoPE, MLPs, embeddings
(twin of ``repro.models.layers``).

Numerics policy, as in the reference: parameters and matmul operands in
``cfg.dtype``, matmul accumulation in f32, normalisation statistics,
softmax and logits in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.parallel.api import (current_mesh, is_dtensor,
                                      mesh_sizes, named_sharding, shard)

__all__ = ["DTYPES", "cdtype", "mm", "dense", "norm_apply", "rope",
           "mlp_apply", "embed_apply", "unembed_apply", "model_axis"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def model_axis() -> int:
    """The size of the active mesh's ``model`` axis (1 without a mesh)."""
    mesh = current_mesh()
    return 1 if mesh is None else mesh_sizes(mesh).get("model", 1)


def mm(a: torch.Tensor, b: torch.Tensor,
       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` (broadcasting like ``torch.matmul``) accumulated in f32;
    the result is f32, or ``out_dtype`` when given.

    On the CPU the operands are upcast to f32, which is how the reference
    executes bf16 dots on XLA:CPU.  On the GPU a bf16/fp16 product that
    returns its own dtype goes to cuBLAS as is (f32 accumulation, one
    rounding at the end); one that returns f32 against a 2-D weight asks
    cuBLAS for an f32 output directly, so the weight is never upcast.
    That product has no derivative in PyTorch; when an operand requires
    grad it runs through :class:`_MmF32`, whose backward rounds the f32
    output gradient to the operands' dtype once and accumulates both
    products in f32.  Meta tensors take the GPU's route: the perf layer's
    graph capture (:mod:`repro_torch.perf.torch_graph`) records the
    products the card runs.

    Under a mesh a DTensor operand keeps at most its first batch dim
    sharded (:func:`_foldable`) before the product folds its batch dims.
    """
    out = torch.float32 if out_dtype is None else out_dtype
    if current_mesh() is None:
        return _mm(a, b, out)
    trailing = 1 if b.dim() == 2 else 2
    a, b = _foldable(a, trailing), _foldable(b, 2)
    return _grad_as_output(_mm(a, b, out))


def _mm(a: torch.Tensor, b: torch.Tensor, out: torch.dtype) -> torch.Tensor:
    low = a.dtype in (torch.bfloat16, torch.float16)
    if a.device.type in ("cuda", "meta") and low:
        if out == a.dtype:
            return torch.matmul(a, b)
        if b.dim() == 2 and out == torch.float32:
            a2 = a.reshape(-1, a.shape[-1])
            if torch.is_grad_enabled() and (a.requires_grad
                                            or b.requires_grad):
                y = _MmF32.apply(a2, b)
            else:
                y = torch.mm(a2, b, out_dtype=out)
            return y.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float()).to(out)


def _foldable(t: torch.Tensor, trailing: int) -> torch.Tensor:
    """``t`` laid out so that a product may fold its batch dims (all but
    the ``trailing`` ones) into one: a DTensor keeps a split of its first
    batch dim and gathers any other (sequence-parallel rows are gathered
    before a tensor-parallel product, as Megatron-SP does; DTensor cannot
    view two split dims as one on every torch the port runs on)."""
    if not is_dtensor(t) or t.dim() - trailing < 2:
        return t
    from torch.distributed.tensor import Replicate, Shard
    lead = t.dim() - trailing
    want = [Replicate() if isinstance(p, Shard) and 0 < p.dim < lead else p
            for p in t.placements]
    if want == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, want)


def _grad_as_output(y: torch.Tensor) -> torch.Tensor:
    """``y``, whose gradient is made foldable (:func:`_foldable`) on its
    way back: the product's backward folds the gradient's batch dims as
    the forward folded its operand's."""
    if not is_dtensor(y) or not y.requires_grad or y.dim() < 3:
        return y
    return _FoldableGrad.apply(y)


class _FoldableGrad(torch.autograd.Function):
    """The identity; its backward lays the gradient out by
    :func:`_foldable`."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _foldable(g, 1)


class _MmF32(torch.autograd.Function):
    """a (M, K) @ b (K, N) of bf16/f16 operands with an f32 output (one
    cuBLAS call), differentiable."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = torch.mm(g, b.t()) if ctx.needs_input_grad[0] else None
        gb = torch.mm(a.t(), g) if ctx.needs_input_grad[1] else None
        return ga, gb


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b): f32 accumulation, result in x.dtype."""
    y = mm(x, w, out_dtype=x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def norm_apply(cfg: ModelConfig, w, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm in f32, cast back to x.dtype.

    ``w`` is the scale vector (rms) or {"scale", "bias"} (layer)."""
    xf = x.float()
    if cfg.norm_type == "layer":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * w["scale"].float() + w["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps)
        y = y * w.float()
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., seq, heads, head_dim); positions:
    (seq,) or (batch, seq)."""
    hd = x.shape[-1]
    half = hd // 2
    # log(theta) in f32, as the reference computes it
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32)
                      * (log_theta / half)).to(x.device)
    ang = positions.float()[..., None] * freqs               # (.., S, half)
    ang = ang[..., None, :]                                  # over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


def mlp_apply(cfg: ModelConfig, w, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU (wi/wg/wo) or GELU (wi/wo) feed-forward."""
    if cfg.mlp_type == "gelu":
        h = F.gelu(dense(x, w["wi"], w.get("bi")), approximate="tanh")
    else:
        h = F.silu(dense(x, w["wg"])) * dense(x, w["wi"])
    h = shard(h, "batch", None, "tp")
    return dense(h, w["wo"], w.get("bo"))


def embed_apply(cfg: ModelConfig, w_embed: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup; (B, S) int -> (B, S, D).  Under a mesh
    the weight is laid out on D (the lookup's passthrough dim), as in the
    reference, and the lookup runs on each rank's block
    (:func:`_lookup_on_shards`)."""
    if is_dtensor(w_embed):
        h = _lookup_on_shards(shard(w_embed, None, "tp"), tokens)
    else:
        h = w_embed[tokens]
    return shard(h.to(cdtype(cfg)), "batch", "seq", None)


def _lookup_on_shards(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``w[tokens]`` under ``local_map``: tokens on ``batch`` (a plain
    tensor taken as replicated), ``w`` as it is laid out; the output split
    as the tokens on their axes and as ``w``'s columns on its own.  The
    weight's gradient is a partial sum over the tokens' axes (each rank
    scatters its own tokens' rows).  Explicit placements, because
    DTensor's rule for the gradient's ``index_put`` fails on some
    torch versions the port runs on."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    t_pl = named_sharding(tokens.shape,
                          ("batch",) + (None,) * (tokens.dim() - 1), mesh)
    w_pl, out_pl, grad_pl = [], [], []
    for tp, wp in zip(t_pl, w.placements):
        if isinstance(tp, Shard):       # a mesh dim of the tokens' own
            w_pl.append(Replicate())
            out_pl.append(tp)
            grad_pl.append(Partial())
        else:
            w_pl.append(wp)
            out_pl.append(Shard(tokens.dim()) if isinstance(wp, Shard)
                          else Replicate())
            grad_pl.append(wp)
    return local_map(lambda wl, tl: wl[tl], out_placements=out_pl,
                     in_placements=(w_pl, t_pl),
                     in_grad_placements=(grad_pl, t_pl), device_mesh=mesh,
                     redistribute_inputs=True)(w, tokens)


def unembed_apply(cfg: ModelConfig, w_unembed: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> f32 logits (B, S, V): vocab-sharded under a mesh when
    V divides the model axis, else sequence-sharded."""
    w_unembed = shard(w_unembed, None, "vocab")
    logits = mm(h, w_unembed)
    if w_unembed.shape[-1] % model_axis() == 0:
        return shard(logits, "batch", None, "vocab")
    return shard(logits, "batch", "seq", None)
