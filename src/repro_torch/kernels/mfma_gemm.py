"""The MFMA contract at GEMM scale, D = C + A @ B: the wrapper around the
CUDA kernel and its plain PyTorch version (twin of
``repro.kernels.mfma_gemm``).

a (M, K) @ b (K, N) + c (M, N) -> (M, N) in c's dtype: the f32
accumulator is seeded from C, the products are added in f32 and the
result is rounded once to C's dtype.  a and b share f32, bf16 or f16; c
is f32, bf16 or f16.

* On a CUDA tensor :func:`mfma_gemm` launches the kernel in
  ``csrc/mfma_gemm.cu`` (built on first use) or raises: bf16 and f16
  operands run on the tensor cores (M > 64: ``wgmma`` fed by TMA; M <= 64,
  the decode rows: ``mma.sync`` streaming b, split over K by
  :func:`decode_splits` when its column tiles are too few to fill the
  card), f32 operands on CUDA cores in exact f32.  The wrapper keeps the
  split's f32 partials and its tickets per (device, stream).
* On a CPU tensor it runs :func:`mfma_gemm_plain`, the kernel's K loop
  written with PyTorch ops.  The CPU tests hold it against the
  reference's Pallas kernel in interpret mode, and ``chip_smoke.py``
  holds the CUDA kernel against it on the card.

Ragged M, N and K need no padding: the kernel masks them itself (loads
past an edge read zero, stores past it never happen), which computes
what the reference's zero-pad and slice wrapper
(``repro.kernels.ops.mfma_gemm(pad=True)``) computes.  Unlike the
reference, which raises on a dimension below its 128-wide MXU tile, the
port takes any size (M = 8, K = 250).

The reference's models never call it; it is the paper's own contract,
reached from ``repro_torch.core.functional`` by composition.

``LAUNCHES`` counts kernel launches (plain runs are not counted).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build

__all__ = ["mfma_gemm", "mfma_gemm_plain", "decode_splits", "LAUNCHES",
           "BLOCK_K"]

NAME = "mfma_gemm"
LAUNCHES: Dict[str, int] = {NAME: 0}
BLOCK_K = 64                    # contraction depth of a kernel slice (kWK, kDK)
DECODE_ROWS = 64                # M up to this takes the decode path
DECODE_COLUMNS = 64             # output columns of a decode block (kDN)
BLOCKS_PER_SM = 6               # the decode path's target, as splits allow
# The tiles the kernels fix in csrc/mfma_gemm.cu (line numbers there),
# named here for the perf layer's planner (repro_torch.kernels.plan):
WGMMA_ROWS = 128                # output rows of a wgmma block (kWM, :363)
WGMMA_COLUMNS = 256             # its output columns (kWN, :364)
WGMMA_M = 64                    # rows of one wgmma, m64n256k16 (:6)
STAGES = 4                      # slices in the wgmma, decode rings (:366)
DECODE_ROW_TILES = (16, 32, 64)  # decode blocks' rows: least >= M (:639)
VECTOR = 8                      # K, N multiples of this: the rings (:638)
TILE = 64                       # element-load, f32 blocks' rows, cols (:95)
TILE_K = 32                     # their contraction depth a slice (:97)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
_SCRATCH: Dict[tuple, tuple] = {}
_SMS: Dict[int, int] = {}


def mfma_gemm_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
                    block_k: int = BLOCK_K) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: an f32 accumulator seeded
    from c, one f32 product of each ``block_k``-deep slice of a and b
    added to it, one rounding to c's dtype at the end."""
    if block_k < 1:
        raise ValueError(f"{NAME}: block_k must be positive, got {block_k}")
    acc = c.float()
    for k in range(0, a.shape[1], block_k):
        acc = acc + a[:, k:k + block_k].float() @ b[k:k + block_k].float()
    return acc.to(c.dtype)


def _check(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or c.dim() != 2 or \
            a.shape[1] != b.shape[0] or \
            tuple(c.shape) != (a.shape[0], b.shape[1]):
        raise ValueError(
            f"{NAME}: incompatible operands a{tuple(a.shape)} @ "
            f"b{tuple(b.shape)} + c{tuple(c.shape)}; need a(M,K), b(K,N), "
            "c(M,N)")
    M, K = a.shape
    N = b.shape[1]
    if min(M, N, K) < 1:
        raise ValueError(f"{NAME}: empty operand: M={M}, N={N}, K={K}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise ValueError(f"{NAME}: a and b must share one of "
                         f"{list(_DTYPE_CODES)}, got {a.dtype} and {b.dtype}")
    if c.dtype not in _DTYPE_CODES:
        raise ValueError(f"{NAME}: c must be one of {list(_DTYPE_CODES)}, "
                         f"got {c.dtype}")
    if b.device != a.device or c.device != a.device:
        raise ValueError(f"{NAME}: all operands must be on {a.device}, got "
                         f"{b.device} and {c.device}")
    if not (a.is_contiguous() and b.is_contiguous() and c.is_contiguous()):
        raise ValueError(f"{NAME}: operands must be contiguous")


def decode_splits(M: int, N: int, K: int, sms: int) -> int:
    """The split over K the decode path (M <= 64) takes: enough splits
    of its 64-column tiles for six blocks an SM (the card keeps four of
    them resident; the rest follow as the first finish, which keeps b's
    bytes in flight to the end), each split at least 4 slices of
    ``BLOCK_K`` deep, at most 8 splits."""
    tiles = -(-N // DECODE_COLUMNS)
    if M > DECODE_ROWS or tiles >= BLOCKS_PER_SM * sms:
        return 1
    slices = -(-K // BLOCK_K)
    return max(1, min(-(-BLOCKS_PER_SM * sms // tiles), slices // 4, 8))


def _split_scratch(device, stream: int, n_part: int, n_tickets: int):
    """(partials, tickets) pointers for a split launch on ``stream``: the
    f32 partials each launch writes before it reads them, and the tickets,
    zero between launches (the last block of each column tile resets its
    own).  Drawn once a stream, grown when a launch needs more."""
    key = (device, stream)
    part, tickets = _SCRATCH.get(key, (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 1024), dtype=torch.int32,
                              device=device)
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    _SCRATCH[key] = (part, tickets)
    return part.data_ptr(), tickets.data_ptr()


def _kernel(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    M, K = a.shape
    N = b.shape[1]
    if (M + 63) // 64 > 65535 or max(M, N, K) >= 2 ** 31:
        raise ValueError(f"{NAME}: M={M}, N={N}, K={K} is out of the "
                         "kernel's range (at most 65535 tiles of 64 rows, "
                         "each dimension below 2**31)")
    d = torch.empty((M, N), dtype=c.dtype, device=c.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    splits, part, tickets = 1, None, None
    if a.dtype != torch.float32 and M <= DECODE_ROWS:
        index = a.device.index
        if index not in _SMS:
            _SMS[index] = torch.cuda.get_device_properties(
                a.device).multi_processor_count
        splits = decode_splits(M, N, K, _SMS[index])
        if splits > 1:
            part, tickets = _split_scratch(a.device, stream, splits * M * N,
                                           -(-N // DECODE_COLUMNS))
    build.launch(NAME, _ARGS, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 d.data_ptr(), M, N, K, _DTYPE_CODES[a.dtype],
                 _DTYPE_CODES[c.dtype], splits, part, tickets, stream,
                 device=a.device)
    LAUNCHES[NAME] += 1
    return d


def mfma_gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
              ) -> torch.Tensor:
    """a (M, K) @ b (K, N) + c (M, N) -> (M, N) in c's dtype, accumulated
    in f32 from c.  Raises ``ValueError`` for operands the kernel does
    not take (mismatched shapes: "incompatible operands")."""
    build.no_grad_operands(NAME, a, b, c)
    _check(a, b, c)
    if a.device.type == "cpu":
        return mfma_gemm_plain(a, b, c)
    if a.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {a.device}")
    return _kernel(a, b, c)
