"""Chunked Mamba-2 SSD scan: the wrapper around the CUDA kernel and its
plain PyTorch version (twin of ``repro.kernels.mamba2_ssd``).

x (B, S, nh, hd), dt (B, S, nh) f32 after softplus, A (nh,) f32
negative, Bm/Cm (B, S, G, ds) shared by the nh / G heads of a group ->
y (B, S, nh, hd) in x's dtype and the final state (B, nh, hd, ds) in
f32.  Every SSM layer runs it twice on a prefill (the layer's output and
the state it hands to decode).

* On a CUDA tensor :func:`mamba2_ssd` launches the kernels in
  ``csrc/mamba2_ssd.cu`` (built on first use) or raises.  One call
  enqueues three CUDA kernels on the current stream, all chunks of all
  heads in parallel: the scores (once per B/C group) with the chunk
  states from zero, the scan over chunks, the outputs.  ``LAUNCHES``
  counts one per call, however many kernels the call enqueues, so that
  a count still reads "SSD scans run".  The call draws its f32 scratch
  (scores, chunk states, chunk totals) on the stream.
* On a CPU tensor it runs :func:`mamba2_ssd_plain`, the kernels' four
  passes written with PyTorch ops: the same masks and exps, f32
  throughout, y rounded once to x's dtype.  The CPU tests hold it
  against the reference's Pallas kernel in interpret mode (at the
  reference's chunk), and ``chip_smoke.py`` holds the CUDA kernels
  against it on the card (at the kernels' own chunk, ``CHUNK``).

Ragged S needs no padding: rows past S read as zeros with dt = 0, which
are identity steps (no decay, no input), so they add nothing to y or to
the state; this computes what the reference's wrapper computes by
padding with such steps (``repro.kernels.ops.mamba2_ssd(pad=True)``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

__all__ = ["mamba2_ssd", "mamba2_ssd_plain", "LAUNCHES", "CHUNK"]

NAME = "mamba2_ssd"
LAUNCHES: Dict[str, int] = {NAME: 0}
CHUNK = 128                     # rows per chunk of the CUDA kernels (kQ)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
D_STATES = (16, 32, 64, 128)    # the state sizes the kernels are built for
HD_QUANTUM = 16                 # hd: the kernels' 16-row fragments along it
_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _chunks(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """t (B, S, ...) as f32 chunks (B, nc, chunk, ...), zero rows past S."""
    B, S = t.shape[:2]
    nc = -(-S // chunk)
    t = t.float()
    if nc * chunk != S:
        pad = t.new_zeros((B, nc * chunk - S) + tuple(t.shape[2:]))
        t = torch.cat([t, pad], dim=1)
    return t.reshape((B, nc, chunk) + tuple(t.shape[2:]))


def _cum_and_scores(dt, A, Bm, Cm, chunk: int):
    """Pass (a): per chunk, cum (B, nc, nh, Q), the inclusive scan of
    dt * A per head, and the scores C_i . B_j (B, nc, G, Q, Q) once per
    group; also dt as (B, nc, nh, Q)."""
    dtq = _chunks(dt, chunk).transpose(2, 3)                 # (B,nc,nh,Q)
    cum = torch.cumsum(dtq * A.float()[None, None, :, None], dim=-1)
    Cq = _chunks(Cm, chunk).permute(0, 1, 3, 2, 4)           # (B,nc,G,Q,ds)
    Bq = _chunks(Bm, chunk).permute(0, 1, 3, 2, 4)
    return cum, dtq, Cq @ Bq.transpose(-1, -2)


def _local_states(x, dtq, cum, Bm, chunk: int) -> torch.Tensor:
    """Pass (b): each chunk's state from zero, (B, nc, nh, hd, ds):
    sum_j (x_j * exp(total - cum_j) * dt_j) B_j^T."""
    nh = x.shape[2]
    hpg = nh // Bm.shape[2]
    xq = _chunks(x, chunk).permute(0, 1, 3, 2, 4)            # (B,nc,nh,Q,hd)
    Bh = _chunks(Bm, chunk).permute(0, 1, 3, 2, 4) \
        .repeat_interleave(hpg, dim=2)                       # (B,nc,nh,Q,ds)
    decay = torch.exp(cum[..., -1:] - cum) * dtq             # (B,nc,nh,Q)
    return (xq * decay[..., None]).transpose(-1, -2) @ Bh


def _carried_states(local: torch.Tensor, cum: torch.Tensor):
    """Pass (c): the scan over chunks, h_c = exp(total_c) h_{c-1} +
    local_c.  Returns the state each chunk starts from (B, nc, nh, hd, ds)
    and the final state (B, nh, hd, ds)."""
    decay = torch.exp(cum[..., -1])                          # (B,nc,nh)
    h = torch.zeros_like(local[:, 0])
    starts = []
    for c in range(local.shape[1]):
        starts.append(h)
        h = decay[:, c, :, None, None] * h + local[:, c]
    return torch.stack(starts, dim=1), h


def _outputs(x, dtq, cum, scores, Cm, starts, chunk: int) -> torch.Tensor:
    """Pass (d): y per chunk, ``W x + (C h^T) * exp(cum)`` with ``W =
    scores * exp(cum_i - cum_j) * dt_j`` for j <= i (masked inside the
    exp), rounded once to x's dtype."""
    B, S, nh, hd = x.shape
    hpg = nh // Cm.shape[2]
    idx = torch.arange(chunk, device=x.device)
    causal = idx[None, :] <= idx[:, None]                    # j <= i
    L = torch.exp(torch.where(causal, cum[..., :, None] - cum[..., None, :],
                              -1e30))                        # (B,nc,nh,Q,Q)
    W = scores.repeat_interleave(hpg, dim=2) * L * dtq[..., None, :]
    xq = _chunks(x, chunk).permute(0, 1, 3, 2, 4)            # (B,nc,nh,Q,hd)
    Ch = _chunks(Cm, chunk).permute(0, 1, 3, 2, 4) \
        .repeat_interleave(hpg, dim=2)                       # (B,nc,nh,Q,ds)
    y_intra = W @ xq
    y_inter = (Ch @ starts.transpose(-1, -2)) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).to(x.dtype)                      # (B,nc,nh,Q,hd)
    return y.permute(0, 1, 3, 2, 4).reshape(B, -1, nh, hd)[:, :S]


def mamba2_ssd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor, *,
                     chunk: int = CHUNK
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' four passes in PyTorch ops, vectorised over requests,
    heads and chunks of ``chunk`` rows (rows past S are zero identity
    steps): (a) cum and the scores once per group, (b) every chunk's
    state from zero, (c) the scan over chunks, (d) every chunk's y."""
    cum, dtq, scores = _cum_and_scores(dt, A, Bm, Cm, chunk)
    local = _local_states(x, dtq, cum, Bm, chunk)
    starts, h = _carried_states(local, cum)
    return _outputs(x, dtq, cum, scores, Cm, starts, chunk), h


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
    if ds not in D_STATES:
        raise ValueError(f"{NAME}: state size ds={ds} not in {D_STATES}")
    if hd < HD_QUANTUM or hd % HD_QUANTUM:
        raise ValueError(f"{NAME}: head dim hd={hd} is not a positive "
                         f"multiple of {HD_QUANTUM}")
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
    nc = -(-S // CHUNK)
    y = torch.empty_like(x)
    state = torch.empty((B, nh, hd, ds), dtype=torch.float32,
                        device=x.device)
    # scores (B, G, nc, Q, Q), chunk states (B, nh, nc, hd, ds), totals
    scratch = torch.empty(B * G * nc * CHUNK * CHUNK
                          + B * nh * nc * (hd * ds + 1),
                          dtype=torch.float32, device=x.device)
    build.launch(NAME, _ARGS, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                 Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                 scratch.data_ptr(), B, S, nh, hd, G, ds,
                 _DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream,
                 device=x.device)
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
    build.no_grad_operands(NAME, x, dt, A, Bm, Cm)
    _check(x, dt, A, Bm, Cm)
    if x.device.type == "cpu":
        return mamba2_ssd_plain(x, dt, A, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {x.device}")
    return _kernel(x, dt, A, Bm, Cm)
