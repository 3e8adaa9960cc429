"""Chunked Mamba-2 SSD scan: the wrapper around the CUDA kernel and its
plain PyTorch version (twin of ``repro.kernels.mamba2_ssd``).

x (B, S, nh, hd), dt (B, S, nh) f32 after softplus, A (nh,) f32
negative, Bm/Cm (B, S, G, ds) shared by the nh / G heads of a group ->
y (B, S, nh, hd) in x's dtype and the final state (B, nh, hd, ds) in
f32.  Every SSM layer runs it twice on a prefill (the layer's output and
the state it hands to decode).

* On a CUDA tensor :func:`mamba2_ssd` launches the kernel in
  ``csrc/mamba2_ssd.cu`` (built on first use) or raises.
* On a CPU tensor it runs :func:`mamba2_ssd_plain`, the kernel's chunk
  loop written with PyTorch ops: the same masks and exps, f32
  throughout, each chunk's y rounded once to x's dtype.  The CPU tests
  hold it against the reference's Pallas kernel in interpret mode (at
  the reference's chunk), and ``chip_smoke.py`` holds the CUDA kernel
  against it on the card (at the kernel's own chunk, ``CHUNK``).

Ragged S needs no padding: rows past S read as zeros with dt = 0, which
are identity steps (no decay, no input), so they add nothing to y or to
the state; this computes what the reference's wrapper computes by
padding with such steps (``repro.kernels.ops.mamba2_ssd(pad=True)``).

``LAUNCHES`` counts kernel launches (plain runs are not counted), so a
run can show that its prefills went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

__all__ = ["mamba2_ssd", "mamba2_ssd_plain", "LAUNCHES", "CHUNK"]

NAME = "mamba2_ssd"
LAUNCHES: Dict[str, int] = {NAME: 0}
CHUNK = 64                      # rows per chunk of the CUDA kernel (kQ)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_D_STATES = (16, 32, 64, 128)
_HD_QUANTUM = 16                # state rows per block (kHS)


def _rows(t: torch.Tensor, t0: int, chunk: int) -> torch.Tensor:
    """Rows [t0, t0 + chunk) of t along dim 1 as f32, zeros past the end."""
    part = t[:, t0:t0 + chunk].float()
    n = part.shape[1]
    if n == chunk:
        return part
    pad = part.new_zeros((part.shape[0], chunk - n) + tuple(part.shape[2:]))
    return torch.cat([part, pad], dim=1)


def mamba2_ssd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor, *,
                     chunk: int = CHUNK
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's chunk loop in PyTorch ops, vectorised over requests
    and heads, walking the sequence in chunks of ``chunk`` rows (rows
    past S are zero identity steps).  Per chunk, as ``_ssd_kernel``:
    ``W = (C B^T) * exp(cum_i - cum_j) * dt_j`` for j <= i (masked inside
    the exp), ``y = W x + (C h^T) * exp(cum)`` rounded to x's dtype, and
    ``h = exp(total) h + (x * exp(total - cum) * dt)^T B``."""
    B, S, nh, hd = x.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    hpg = nh // G
    dev = x.device
    idx = torch.arange(chunk, device=dev)
    causal = idx[None, :] <= idx[:, None]                     # j <= i
    A_f = A.float()[None, :, None]
    h = torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    for t0 in range(0, S, chunk):
        n = min(chunk, S - t0)
        xq = _rows(x, t0, chunk).transpose(1, 2)              # (B,nh,Q,hd)
        dtq = _rows(dt, t0, chunk).transpose(1, 2)            # (B,nh,Q)
        Bq = _rows(Bm, t0, chunk).transpose(1, 2) \
            .repeat_interleave(hpg, dim=1)                    # (B,nh,Q,ds)
        Cq = _rows(Cm, t0, chunk).transpose(1, 2) \
            .repeat_interleave(hpg, dim=1)
        cum = torch.cumsum(dtq * A_f, dim=-1)                 # (B,nh,Q)
        total = cum[..., -1:]                                 # (B,nh,1)
        scores = Cq @ Bq.transpose(-1, -2)                    # (B,nh,Q,Q)
        L = torch.exp(torch.where(causal, cum[..., :, None]
                                  - cum[..., None, :], -1e30))
        W = scores * L * dtq[..., None, :]
        y_intra = W @ xq                                      # (B,nh,Q,hd)
        y_inter = (Cq @ h.transpose(-1, -2)) * torch.exp(cum)[..., None]
        decay = torch.exp(total - cum) * dtq                  # (B,nh,Q)
        h = torch.exp(total)[..., None] * h \
            + (xq * decay[..., None]).transpose(-1, -2) @ Bq  # (B,nh,hd,ds)
        y[:, t0:t0 + n] = (y_intra + y_inter)[:, :, :n].to(x.dtype) \
            .transpose(1, 2)
    return y, h


def _check(x, dt, A, Bm, Cm) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 \
            or Cm.shape != Bm.shape:
        raise ValueError(
            f"{NAME}: want x (B, S, nh, hd), dt (B, S, nh), A (nh,) and "
            f"Bm/Cm (B, S, G, ds) of one shape, got x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, "
            f"Cm {tuple(Cm.shape)}")
    B, S, nh, hd = x.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (B, S, nh) or tuple(A.shape) != (nh,) \
            or tuple(Bm.shape[:2]) != (B, S) or G < 1 or nh % G:
        raise ValueError(
            f"{NAME}: operands disagree: x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm {tuple(Bm.shape)} "
            f"(need matching B, S, nh and a group count G dividing nh)")
    if min(B, S, nh) < 1:
        raise ValueError(f"{NAME}: empty operand: B={B}, S={S}, nh={nh}")
    if ds not in _D_STATES:
        raise ValueError(f"{NAME}: state size ds={ds} not in {_D_STATES}")
    if hd < _HD_QUANTUM or hd % _HD_QUANTUM:
        raise ValueError(f"{NAME}: head dim hd={hd} is not a positive "
                         f"multiple of {_HD_QUANTUM}")
    if x.dtype not in _DTYPE_CODES or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise ValueError(f"{NAME}: x, Bm and Cm must share one of "
                         f"{list(_DTYPE_CODES)}, got {x.dtype}, {Bm.dtype}, "
                         f"{Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"{NAME}: dt and A must be float32, got {dt.dtype} "
                         f"and {A.dtype}")
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError(f"{NAME}: all operands must be on {x.device}")
    if not all(t.is_contiguous() for t in (x, dt, A, Bm, Cm)):
        raise ValueError(f"{NAME}: operands must be contiguous")


def _kernel(x, dt, A, Bm, Cm) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, nh, hd = x.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((B, nh, hd, ds), dtype=torch.float32,
                        device=x.device)
    with torch.cuda.device(x.device):
        build.launch(NAME, [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                     + [ctypes.c_void_p],
                     x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                     Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                     B, S, nh, hd, G, ds, _DTYPE_CODES[x.dtype],
                     torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES[NAME] += 1
    return y, state


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, nh, hd); dt (B, S, nh) f32; A (nh,) f32; Bm/Cm
    (B, S, G, ds) in x's dtype.  Returns (y (B, S, nh, hd) in x's dtype,
    final state (B, nh, hd, ds) f32) from a zero initial state.  Raises
    ``ValueError`` for what the kernel does not take: ds outside
    (16, 32, 64, 128), hd not a multiple of 16, mismatched shapes, types
    or devices, non-contiguous operands."""
    _check(x, dt, A, Bm, Cm)
    if x.device.type == "cpu":
        return mamba2_ssd_plain(x, dt, A, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {x.device}")
    return _kernel(x, dt, A, Bm, Cm)
