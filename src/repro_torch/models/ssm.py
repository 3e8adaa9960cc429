"""Mamba-2 mixer: causal depthwise conv + chunked SSD (twin of
``repro.models.ssm``).

The SSD scan runs the sequence in chunks: attention-like products
within a chunk, a linear f32 state recurrence across chunks.  Shapes:
x (B, S, nh, hd); B/C (B, S, G, ds) shared per group; dt (B, S, nh);
state (B, nh, hd, ds) f32.

With ``cfg.use_kernels`` :func:`ssd_chunked` calls
:func:`repro_torch.kernels.mamba2_ssd` (the CUDA kernel on CUDA tensors,
its plain version on CPU tensors).  There is no fallback: a carried
initial state ``h0`` is not part of the kernel's contract and raises
``NotImplementedError`` (the reference logs a fallback to its plain scan
instead).  Otherwise it runs the reference's ``use_pallas=False`` scan
at ``cfg.ssm.chunk``, which takes ``h0``.  The decode step
(:func:`ssd_step`) has no kernel, as in the reference.

:func:`ssm_decode` updates the layer's cache in place: the new conv
window and state are copied into the ``{"conv", "state"}`` tensors it is
given (the reference returns new ones; the result is the same).  The
two rounding contracts of the reference are kept as they are: the
prefill path adds ``D * x`` to y in f32 and then rounds, the decode
step rounds ``D * x`` to y's dtype before adding it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import mamba2_ssd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cdtype, dense
from repro_torch.parallel.api import assign, shard

__all__ = ["init_ssm", "ssm_train", "ssm_decode", "init_ssm_cache",
           "ssd_chunked", "ssd_step", "d_inner_of"]


def d_inner_of(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = d_inner_of(cfg)
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, nh, conv_dim


def init_ssm(cfg: ModelConfig, gen: torch.Generator,
             device: torch.device) -> Dict:
    """Random weights with the reference's scales; ``A_log``, ``D`` and
    ``dt_bias`` in f32, the rest in ``cfg.dtype``."""
    s = cfg.ssm
    D = cfg.d_model
    d_in, nh, conv_dim = _dims(cfg)
    dt = cdtype(cfg)
    f32 = torch.float32

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dt)

    return {
        # order: [z, x, B, C, dt]
        "in_proj": normal((D, 2 * d_in + 2 * s.n_groups * s.d_state + nh),
                          1.0 / math.sqrt(D)),
        "conv_w": normal((s.d_conv, conv_dim), 0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32,
                                          device=device)),
        "D": torch.ones((nh,), dtype=f32, device=device),
        "dt_bias": torch.zeros((nh,), dtype=f32, device=device),
        "norm": torch.ones((d_in,), dtype=dt, device=device),
        "out_proj": normal((d_in, D), 1.0 / math.sqrt(d_in)
                           / math.sqrt(max(1, cfg.n_layers))),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """z, x, B, C, dt along the last dim of the input projection."""
    s = cfg.ssm
    d_in, nh, _ = _dims(cfg)
    gs = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_in, d_in, gs, gs, nh], dim=-1)


def _conv_train(w, x: torch.Tensor, d_conv: int) -> torch.Tensor:
    """Causal depthwise conv over (B, S, C) as a sum of shifted taps in
    f32 (not ``conv1d``: cuDNN would run it in TF32), then SiLU, rounded
    to x's dtype."""
    S = x.shape[1]
    pads = F.pad(x, (0, 0, d_conv - 1, 0))
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for tau in range(d_conv):
        y = y + pads[:, tau:tau + S].float() * w["conv_w"][tau].float()
    y = y + w["conv_b"].float()
    return F.silu(y).to(x.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None, *,
                use_kernels: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x (B,S,nh,hd); dt (B,S,nh) f32 (post-softplus); A (nh,) f32
    (negative); Bm/Cm (B,S,G,ds).  Returns y (B,S,nh,hd) in x's dtype
    and the final state (B,nh,hd,ds) f32.  ``use_kernels`` runs
    :func:`repro_torch.kernels.mamba2_ssd` (at the kernel's own chunk)
    and raises ``NotImplementedError`` when ``h0`` is given."""
    if use_kernels:
        if h0 is not None:
            raise NotImplementedError(
                "ssd_chunked: a carried initial state h0 is not part of "
                "the mamba2_ssd kernel's contract (it scans from a zero "
                "state); pass use_kernels=False for a prefill continuation")
        return mamba2_ssd(*(t.contiguous() for t in (x, dt, A, Bm, Cm)))
    B, S, nh, hd = x.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    hpg = nh // G
    dev = x.device
    i = torch.arange(chunk, device=dev)
    causal = (i[None, :] <= i[:, None])[None, :, :, None]     # j <= i
    h = torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=dev) \
        if h0 is None else h0
    ys = []
    for t0 in range(0, S, chunk):
        # zero rows past S: dt = 0 makes them identity state updates
        # (exp(0) = 1 decay, zero input contribution)
        xq, dtq, Bq, Cq = (_pad_rows(t[:, t0:t0 + chunk], chunk)
                           for t in (x, dt, Bm, Cm))
        dA = dtq * A                                # (B,Q,nh) log-decay
        cum = torch.cumsum(dA, dim=1)
        total = cum[:, -1]                          # (B,nh)
        scores = torch.einsum("bigs,bjgs->bijg", Cq.float(), Bq.float())
        Lg = cum[:, :, None, :] - cum[:, None, :, :]              # (B,Q,Q,nh)
        # mask before the exp: anti-causal entries are positive log-decays
        W = torch.exp(torch.where(causal, Lg, -1e30))
        W = W * dtq[:, None, :, :]
        W = W * scores.repeat_interleave(hpg, dim=-1)
        y_intra = torch.einsum("bijh,bjhp->bihp", W, xq.float())
        Ch = Cq.repeat_interleave(hpg, dim=2).float()             # (B,Q,nh,ds)
        y_inter = torch.einsum("bihs,bhps->bihp", Ch, h)
        y_inter = y_inter * torch.exp(cum)[..., None]
        decay_j = torch.exp(total[:, None] - cum)                 # (B,Q,nh)
        Bh = Bq.repeat_interleave(hpg, dim=2).float()
        dx = (dtq * decay_j)[..., None] * xq.float()              # (B,Q,nh,hd)
        h = torch.exp(total)[..., None, None] * h + \
            torch.einsum("bjhp,bjhs->bhps", dx, Bh)
        ys.append((y_intra + y_inter).to(x.dtype))
    return torch.cat(ys, dim=1)[:, :S], h


def _pad_rows(t: torch.Tensor, chunk: int) -> torch.Tensor:
    n = t.shape[1]
    if n == chunk:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], chunk - n)
                                     + tuple(t.shape[2:]))], dim=1)


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD update.  x (B,nh,hd); dt (B,nh); Bm/Cm (B,G,ds);
    h (B,nh,hd,ds) f32.  Returns (y in x's dtype, h_new)."""
    nh = x.shape[1]
    hpg = nh // Bm.shape[1]
    da = torch.exp(dt * A)                                     # (B,nh)
    Bh = Bm.repeat_interleave(hpg, dim=1).float()
    Ch = Cm.repeat_interleave(hpg, dim=1).float()
    h_new = da[..., None, None] * h + torch.einsum(
        "bhp,bhs->bhps", dt[..., None] * x.float(), Bh)
    y = torch.einsum("bhs,bhps->bhp", Ch, h_new)
    return y.to(x.dtype), h_new


def _gated_norm(cfg: ModelConfig, w_norm: torch.Tensor, y: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    """Mamba-2 gated RMSNorm: norm(y * silu(z)) in f32, in y's dtype."""
    g = y.float() * F.silu(z.float())
    ms = g.square().mean(-1, keepdim=True)
    return (g * torch.rsqrt(ms + cfg.norm_eps) * w_norm.float()).to(y.dtype)


def _ssm_inputs(cfg: ModelConfig, w, xbc: torch.Tensor, dtr: torch.Tensor):
    """The SSD operands from the conv output and the raw dt projection:
    xh (..., nh, hd), B/C (..., G, ds), dt (..., nh) f32, A (nh,) f32."""
    s = cfg.ssm
    d_in, nh, _ = _dims(cfg)
    gs = s.n_groups * s.d_state
    xs, Bm, Cm = torch.split(xbc, [d_in, gs, gs], dim=-1)
    lead = tuple(xbc.shape[:-1])
    xh = xs.reshape(lead + (nh, s.head_dim))
    Bg = Bm.reshape(lead + (s.n_groups, s.d_state))
    Cg = Cm.reshape(lead + (s.n_groups, s.d_state))
    dt = F.softplus(dtr.float() + w["dt_bias"])
    A = -torch.exp(w["A_log"])
    return xh, Bg, Cg, dt, A


def _scan(cfg: ModelConfig, w, xbc_raw: torch.Tensor, dtr: torch.Tensor):
    """Conv, then the chunked SSD scan over a whole sequence: returns
    xh (B, S, nh, hd), y (B, S, nh, hd) and the final f32 state."""
    xbc = shard(_conv_train(w, xbc_raw, cfg.ssm.d_conv), "batch", None, "tp")
    xh, Bg, Cg, dt, A = _ssm_inputs(cfg, w, xbc, dtr)
    xh = shard(xh, "batch", None, "heads", None)
    dt = shard(dt, "batch", None, "heads")
    y, h = ssd_chunked(xh, dt, A, Bg, Cg, cfg.ssm.chunk,
                       use_kernels=cfg.use_kernels)
    return xh, y, h


def ssm_train(cfg: ModelConfig, w, x: torch.Tensor) -> torch.Tensor:
    """The mixer over a whole sequence: x (B, S, D) -> (B, S, D)."""
    B, S, _ = x.shape
    d_in = d_inner_of(cfg)
    z, xs, Bm, Cm, dtr = _split_proj(cfg, dense(x, w["in_proj"]))
    xh, y, _ = _scan(cfg, w, torch.cat([xs, Bm, Cm], dim=-1), dtr)
    y = y + w["D"].float()[:, None] * xh.float()
    y = shard(y.reshape(B, S, d_in).to(x.dtype), "batch", None, "tp")
    return dense(_gated_norm(cfg, w["norm"], y, z), w["out_proj"])


def init_ssm_cache(cfg: ModelConfig, batch: int, *,
                   device: Union[str, torch.device],
                   dtype: Optional[torch.dtype] = None) -> Dict:
    """Zeroed decode cache of one SSM layer: the last d_conv - 1 conv
    inputs (batch, d_conv - 1, conv_dim) and the f32 state."""
    s = cfg.ssm
    _, nh, conv_dim = _dims(cfg)
    dt = dtype or cdtype(cfg)
    return {"conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dt,
                                device=device),
            "state": torch.zeros((batch, nh, s.head_dim, s.d_state),
                                 dtype=torch.float32, device=device)}


def ssm_decode(cfg: ModelConfig, w, x: torch.Tensor, cache: Dict,
               pos=None) -> Tuple[torch.Tensor, Dict]:
    """x (B, 1, D) -> (y (B, 1, D), cache).  O(1) per token; the state
    summarises the context, so ``pos`` is unused.  The new conv window
    and state are copied into ``cache`` in place."""
    del pos
    B = x.shape[0]
    d_in = d_inner_of(cfg)
    z, xs, Bm, Cm, dtr = _split_proj(cfg, dense(x[:, 0], w["in_proj"]))
    xbc_new = torch.cat([xs, Bm, Cm], dim=-1)                  # (B, conv_dim)
    window = torch.cat([cache["conv"], xbc_new[:, None]], dim=1)
    conv = torch.einsum("btc,tc->bc", window.float(), w["conv_w"].float()) \
        + w["conv_b"].float()
    xbc = F.silu(conv).to(x.dtype)
    xh, Bg, Cg, dt, A = _ssm_inputs(cfg, w, xbc, dtr)
    y, h_new = ssd_step(xh, dt, A, Bg, Cg, cache["state"])
    y = y + (w["D"].float()[:, None] * xh.float()).to(y.dtype)
    y = y.reshape(B, 1, d_in)
    out = dense(_gated_norm(cfg, w["norm"], y, z[:, None]), w["out_proj"])
    assign(cache["conv"], window[:, 1:])
    assign(cache["state"], h_new)
    return out, cache
