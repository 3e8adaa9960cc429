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

__all__ = ["DTYPES", "cdtype", "mm", "dense", "norm_apply", "rope",
           "mlp_apply", "embed_apply", "unembed_apply"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


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
    """
    out = torch.float32 if out_dtype is None else out_dtype
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
    return dense(h, w["wo"], w.get("bo"))


def embed_apply(cfg: ModelConfig, w_embed: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup; (B, S) int -> (B, S, D)."""
    return w_embed[tokens].to(cdtype(cfg))


def unembed_apply(cfg: ModelConfig, w_unembed: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> f32 logits (B, S, V)."""
    return mm(h, w_unembed)
