"""Grouped (per-expert) matmul for capacity-based MoE: the wrapper around
the CUDA kernel and its plain PyTorch version (twin of
``repro.kernels.moe_gmm``).

x (E, C, K) @ w (E, K, N) -> (E, C, N): one GEMM per expert over its C
capacity slots, accumulated in f32 and rounded once to x's dtype.  The
MoE layer runs it three times per layer on every step (the gate, up and
down projections over the expert slot buffers).

* On a CUDA tensor :func:`moe_gmm` launches the kernel in
  ``csrc/moe_gmm.cu`` (built on first use) or raises.  bf16 and f16
  operands whose K and N are multiples of 8 and whose pointers are
  16-byte aligned run on the tensor cores (``mma.sync``), w streamed
  through a cp.async ring, in blocks of 16, 32, 64 or 128 slot rows,
  the smallest that covers C; f32 operands and the other 16-bit ones run
  on CUDA cores.  The kernel chooses by dtype, alignment and shape.
* On a CPU tensor it runs :func:`moe_gmm_plain`: the products in f32,
  rounded once to x's dtype.  The CPU tests hold it against the
  reference's Pallas kernel in interpret mode, and ``chip_smoke.py``
  holds the CUDA kernel against it on the card.

Ragged C, K and N need no padding: the kernel masks them itself (loads
past an edge read zero, stores past it never happen), which computes
what the reference's zero-pad and slice wrapper
(``repro.kernels.ops.moe_gmm(pad=True)``) computes.

``LAUNCHES`` counts kernel launches (plain runs are not counted), so a
run can show that its expert products went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build

__all__ = ["moe_gmm", "moe_gmm_plain", "LAUNCHES"]

NAME = "moe_gmm"
LAUNCHES: Dict[str, int] = {NAME: 0}
# The tiles the kernels fix in csrc/moe_gmm.cu (line numbers there), named
# here for the perf layer's planner (repro_torch.kernels.plan):
RING_COLUMNS = 128              # output columns of a ring block (kRN, :199)
RING_K = 32                     # contraction depth per ring slice (kRK, :200)
RING_STAGES = 4                 # slices in flight (kStages, :201)
RING_ROWS = (16, 32, 64, 128)   # ring row tiles: least >= C (:355)
VECTOR = 8                      # K, N multiples of this: the ring (:352)
TILE = 64                       # gmm_kernel's rows and columns (kBM, kBN, :85)
TILE_K = 32                     # its contraction depth per slice (kBK, :87)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def moe_gmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: f32 products and sums,
    one rounding to x's dtype at the end."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"{NAME}: want x (E, C, K) and w (E, K, N), got x "
                         f"{tuple(x.shape)} and w {tuple(w.shape)}")
    E, C, K = x.shape
    E2, K2, N = w.shape
    if E != E2 or K != K2:
        raise ValueError(
            f"{NAME}: incompatible operands x{tuple(x.shape)} @ "
            f"w{tuple(w.shape)}; need x(E, C, K) and w(E, K, N) with "
            "matching expert count E and contraction depth K")
    if min(E, C, K, N) < 1:
        raise ValueError(f"{NAME}: empty operand: E={E}, C={C}, K={K}, "
                         f"N={N}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"{NAME}: x and w must share one of "
                         f"{list(_DTYPE_CODES)}, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"{NAME}: all operands must be on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{NAME}: operands must be contiguous")


def _kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    E, C, K = x.shape
    N = w.shape[2]
    out = torch.empty((E, C, N), dtype=x.dtype, device=x.device)
    build.launch(NAME, _ARGS, x.data_ptr(), w.data_ptr(), out.data_ptr(), E,
                 C, K, N, _DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream,
                 device=x.device)
    LAUNCHES[NAME] += 1
    return out


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, K) @ w (E, K, N) -> (E, C, N) in x's dtype, accumulated
    in f32.  Raises ``ValueError`` when E or K disagree."""
    build.no_grad_operands(NAME, x, w)
    _check(x, w)
    if x.device.type == "cpu":
        return moe_gmm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {x.device}")
    return _kernel(x, w)
