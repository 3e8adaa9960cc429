"""Flash-decode: the wrappers around the two CUDA decode kernels and their
plain PyTorch versions (twin of ``repro.kernels.decode_attention``).

Each request's one new token attends the first ``kv_len[b]`` rows of its
cache, its G = H / KV query heads of a group together:

* :func:`decode_attention` reads a contiguous (B, T, KV, hd) cache; the
  sync serve engine runs it once per layer on every decode step;
* :func:`paged_decode_attention` reads pool blocks
  ``block_tables[b, 0 .. ceil(kv_len/page))``; the paged serve engine
  runs it once per layer on every decode tick.

On a CUDA tensor each wrapper launches its kernel (built on first use)
or raises.  The two kernels (``csrc/decode_attention.cu`` and
``csrc/paged_decode_attention.cu``) share one body,
``csrc/decode_split.cuh``, and differ only in where a request's row r
lies.  Each request's cache (for the paged one, its table's NB * page
rows) is cut into splits of :func:`kernel_split_rows` rows, a block per
(split, KV head, request), bf16/f16 products on the tensor cores
(``mma.sync``; p as a high and a low half, so that it keeps f32's
precision), each split's unnormalised state in f32 scratch; the last
block of a (request, KV head) to finish, found by an atomic ticket
(counters the kernel resets), combines the splits.  The wrappers draw
the scratch and the tickets once per (device, stream) and keep them.
One launch, one count.

On a CPU tensor each runs its plain version, the kernels' loop written
with PyTorch ops (:func:`_tile_walk` over the kernels' splits, then
their combine): same tiles, same masks, same f32 online softmax and the
same roundings.  Both form scores as ``(q . k) * scale`` and keep p and
PV in f32, so that only the output is rounded, as the tensor-core
kernels do; the reference forms ``(q * scale) . k`` and rounds p and
each tile's PV product to V's dtype.  The paged plain version gathers
the request's pages into a contiguous cache and walks it as the
contiguous one does.  The CPU tests hold the plain versions against the
reference's Pallas kernels in interpret mode, and ``chip_smoke.py``
holds the CUDA kernels against them on the card.

``LAUNCHES`` counts kernel launches by kernel name (plain runs are not
counted), so a run can show that its decode steps went through the
kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Union

import torch

from repro_torch.arch import get_device
from repro_torch.kernels import build

__all__ = ["decode_attention", "decode_attention_plain",
           "paged_decode_attention", "paged_decode_attention_plain",
           "kernel_split_rows", "LAUNCHES", "TILE"]

NAME = "paged_decode_attention"
DECODE = "decode_attention"
LAUNCHES: Dict[str, int] = {DECODE: 0, NAME: 0}
TILE = 64             # cache rows per step of the kernels (kTile)
BLOCKS_PER_SM = 2     # the kernels' target, as splits allow
PAGE_QUANTUM = 16     # a pool page is a multiple of 16 rows ...
MAX_PAGE = 512        # ... up to 512 (the paged cache's pages)
MAX_HD = 256          # head dims up to this ...
HD_QUANTUM = 32       # ... in multiples of this
STAGES = 2            # K and V tiles in flight (csrc/decode_split.cuh:222)

_NEG_INF = -0.7 * torch.finfo(torch.float32).max
_DECODE_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_PAGED_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_SCRATCH: Dict[tuple, tuple] = {}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _tile_walk(qf, k_pool, v_pool, tables, lens, scale):
    """The kernels' tile loop in PyTorch ops, vectorised over requests and
    KV heads: qf (B, KV, G, hd) f32 attends pool blocks
    ``tables[b, 0 .. ceil(lens[b]/page))`` and returns the online
    softmax's state (m, l, acc), (B, KV, G, 1), (B, KV, G, 1) and
    (B, KV, G, hd) f32.  Scores are ``(qf . k) * scale``; p and each
    tile's PV product stay f32.  A request whose pages are exhausted
    keeps its state while longer requests go on, as the kernels' per-request
    tile count does; rows past ``lens`` are masked and their V rows
    zeroed, so stale or poisoned rows never reach the result."""
    B, KV, G, hd = qf.shape
    page = k_pool.shape[1]
    dev = qf.device
    m = torch.full((B, KV, G, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, hd), dtype=torch.float32, device=dev)
    n_pages = int((lens.max().clamp(min=0) + page - 1) // page) if B else 0
    cols = torch.arange(page, device=dev)
    for j in range(n_pages):
        k = k_pool[tables[:, j]].float()                    # (B, page, KV, hd)
        valid = (j * page + cols)[None, :] < lens[:, None]  # (B, page)
        v = torch.where(valid[:, :, None, None], v_pool[tables[:, j]],
                        torch.zeros((), dtype=v_pool.dtype, device=dev))
        s = torch.einsum("bkgd,btkd->bkgt", qf, k) * scale
        s = torch.where(valid[:, None, None, :], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1, keepdim=True)
        acc_new = acc * corr + torch.einsum("bkgt,btkd->bkgd", p, v.float())
        live = (j * page < lens)[:, None, None, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    return m, l, acc


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, kv_len, *,
                                 split_rows: Optional[int] = None):
    """The paged kernel's loop: each request's table pages gathered into
    a contiguous (B, NB * page, KV, hd) cache, walked as
    :func:`decode_attention_plain` walks it, in splits of ``split_rows``
    rows (default: the kernel's, :func:`kernel_split_rows` of the table
    capacity NB * page), each in 64-row tiles, the splits combined in
    f32.  Rows past ``kv_len`` (the last page's tail, the null block
    that unused slots point at) are masked as the kernel masks them."""
    B, H, hd = q.shape
    KV = k_pool.shape[2]
    tables = block_tables.to(device=q.device, dtype=torch.long)
    k = k_pool[tables].reshape(B, -1, KV, hd)
    v = v_pool[tables].reshape(B, -1, KV, hd)
    R = kernel_split_rows(k.shape[1], B * KV) if split_rows is None \
        else split_rows
    return decode_attention_plain(q, k, v, kv_len, split_rows=R)


def _check(q, k_pool, v_pool, block_tables, kv_len) -> None:
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"{NAME}: want q (B, H, hd) and k/v pools (P, page, KV, hd) of "
            f"one shape, got q {tuple(q.shape)}, k_pool "
            f"{tuple(k_pool.shape)}, v_pool {tuple(v_pool.shape)}")
    B, H, hd = q.shape
    KV = k_pool.shape[2]
    if k_pool.shape[3] != hd or H % KV:
        raise ValueError(f"{NAME}: q heads {H} x {hd} do not group over "
                         f"pool heads {KV} x {k_pool.shape[3]}")
    if hd % HD_QUANTUM or hd > MAX_HD:
        raise ValueError(f"{NAME}: head dim {hd} must be a multiple of "
                         f"{HD_QUANTUM} and at most {MAX_HD}")
    page = k_pool.shape[1]
    if page % PAGE_QUANTUM or not PAGE_QUANTUM <= page <= MAX_PAGE:
        raise ValueError(f"{NAME}: page {page} must be a multiple of "
                         f"{PAGE_QUANTUM} rows between {PAGE_QUANTUM} and "
                         f"{MAX_PAGE}")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"{NAME}: q/k/v must share one of "
                         f"{list(_DTYPE_CODES)}, got {q.dtype}, "
                         f"{k_pool.dtype}, {v_pool.dtype}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or kv_len.shape != (B,):
        raise ValueError(f"{NAME}: want block_tables (B, NB) and kv_len "
                         f"(B,) for B={B}, got {tuple(block_tables.shape)} "
                         f"and {tuple(kv_len.shape)}")
    if block_tables.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise ValueError(f"{NAME}: block_tables and kv_len must be int32, "
                         f"got {block_tables.dtype} and {kv_len.dtype}")
    ts = (q, k_pool, v_pool, block_tables, kv_len)
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{NAME}: all operands must be on {q.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{NAME}: operands must be contiguous")


def _kernel(q, k_pool, v_pool, block_tables, kv_len) -> torch.Tensor:
    B, H, hd = q.shape
    page, KV = k_pool.shape[1], k_pool.shape[2]
    NB = block_tables.shape[1]
    R = kernel_split_rows(NB * page, B * KV)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    acc, m, l, tickets = _split_state(q.device, stream, B, H, KV, hd,
                                      -(-NB * page // R))
    build.launch(NAME, _PAGED_ARGS, q.data_ptr(), k_pool.data_ptr(),
                 v_pool.data_ptr(), block_tables.data_ptr(),
                 kv_len.data_ptr(), out.data_ptr(), acc, m, l, tickets, B, H,
                 KV, hd, page, NB, R, 1.0 / math.sqrt(hd),
                 _DTYPE_CODES[q.dtype], stream, device=q.device)
    LAUNCHES[NAME] += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd); k_pool/v_pool (P, page, KV, hd); block_tables (B, NB)
    int32 physical block ids; kv_len (B,) int32.  Returns (B, H, hd) in
    q's dtype.

    Table slots the request attends must hold in-range block ids (the
    engine points unused slots at its null block 0); they are not
    checked here, because that would stall every decode tick on a
    device-to-host copy."""
    build.no_grad_operands(NAME, q, k_pool, v_pool)
    _check(q, k_pool, v_pool, block_tables, kv_len)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {q.device}")
    return _kernel(q, k_pool, v_pool, block_tables, kv_len)


# -- the contiguous cache ---------------------------------------------------

def _lens(kv_len, B: int, T: int, device) -> torch.Tensor:
    """``kv_len`` (an int or a (B,) tensor) as (B,) int32, clamped to T."""
    if isinstance(kv_len, torch.Tensor) and kv_len.dim() == 1:
        return kv_len.to(device=device, dtype=torch.int32).clamp(max=T)
    return torch.full((B,), min(int(kv_len), T), dtype=torch.int32,
                      device=device)


def kernel_split_rows(T: int, batch_kv: int) -> int:
    """Rows R of one split of the decode kernels for a cache of T rows
    (the paged kernel's T is its table capacity NB * page) and
    ``batch_kv`` = B * KV (request, KV head) pairs: a multiple of the
    64-row tile, at least two tiles (below that a split's fixed costs
    outweigh its rows), and otherwise small enough that
    ``BLOCKS_PER_SM`` blocks an SM of the port's card (the ``h100``
    spec's SMs) run when every split is live.  Read from the shapes
    alone: the lengths live on the card, and reading them would stall
    every decode step on a copy to the host."""
    sms = get_device("h100").cu_count
    splits = -(-BLOCKS_PER_SM * sms // max(batch_kv, 1))
    rows = -(-T // splits)
    return max(2 * TILE, -(-rows // TILE) * TILE)


def decode_attention_plain(q, k, v, kv_len, *, block_kv: int = TILE,
                           split_rows: Optional[int] = None
                           ) -> torch.Tensor:
    """The kernel's loop in PyTorch ops.  Request b's rows are cut into
    splits of ``split_rows`` rows (default: the kernel's,
    :func:`kernel_split_rows`); each split is walked from m = -inf in
    tiles of ``block_kv`` rows (the last cut at the split's end), the
    paged loop over a pool whose page is the tile; then the splits are
    combined in f32, in order: M = max m_s, L = sum l_s e^(m_s - M),
    out = sum acc_s e^(m_s - M) / max(L, 1e-30).  With
    ``split_rows >= T`` this is one walk of the whole cache."""
    B, T, KV, hd = k.shape
    H = q.shape[1]
    G = H // KV
    R = kernel_split_rows(T, B * KV) if split_rows is None \
        else int(split_rows)
    if R < 1:
        raise ValueError(f"{DECODE}: split_rows must be positive, got {R}")
    ns = -(-T // R)
    nt = -(-R // block_kv)               # tiles of a split, the last cut
    lens = _lens(kv_len, B, T, q.device).long()

    def splits(x):              # (B, T, KV, hd) -> (B * ns * nt, bk, KV, hd)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, ns * R - T))
        x = x.reshape(B * ns, R, KV, hd)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, nt * block_kv - R))
        return x.reshape(B * ns * nt, block_kv, KV, hd)

    starts = torch.arange(ns, device=q.device) * R
    split_lens = (lens[:, None] - starts[None, :]).clamp(0, R).reshape(-1)
    tables = torch.arange(B * ns * nt, device=q.device).reshape(B * ns, nt)
    qf = q.reshape(B, 1, KV, G, hd).float().expand(B, ns, KV, G, hd)
    m, l, acc = _tile_walk(qf.reshape(B * ns, KV, G, hd), splits(k),
                           splits(v), tables, split_lens,
                           1.0 / math.sqrt(hd))
    m, l, acc = (x.reshape(B, ns, KV, G, -1) for x in (m, l, acc))
    M = m.amax(1)
    L = torch.zeros_like(M)
    out = torch.zeros_like(acc[:, 0])
    for s in range(ns):
        w = torch.exp(m[:, s] - M)
        L = L + l[:, s] * w
        out = out + acc[:, s] * w
    out = out / torch.clamp(L, min=1e-30)
    return out.to(q.dtype).reshape(B, H, hd)


def _check_decode(q, k, v, kv_len) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"{DECODE}: want q (B, H, hd) and k/v (B, T, KV, hd) of one "
            f"shape, got q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}")
    B, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"{DECODE}: q {tuple(q.shape)} does not group over "
                         f"k/v {tuple(k.shape)} (batch, head dim, H % KV)")
    if hd % HD_QUANTUM or hd > MAX_HD:
        raise ValueError(f"{DECODE}: head dim {hd} must be a multiple of "
                         f"{HD_QUANTUM} and at most {MAX_HD}")
    if min(B, k.shape[1]) < 1:
        raise ValueError(f"{DECODE}: empty operand: B={B}, T={k.shape[1]}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{DECODE}: q/k/v must share one of "
                         f"{list(_DTYPE_CODES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if isinstance(kv_len, torch.Tensor) and kv_len.dim() > 0:
        if kv_len.shape != (B,) or kv_len.dtype != torch.int32 \
                or kv_len.device != q.device:
            raise ValueError(
                f"{DECODE}: kv_len must be an int or a ({B},) int32 tensor "
                f"on {q.device}, got {tuple(kv_len.shape)} {kv_len.dtype} "
                f"on {kv_len.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{DECODE}: all operands must be on {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{DECODE}: operands must be contiguous")


def _split_state(device, stream: int, B: int, H: int, KV: int, hd: int,
                 ns: int):
    """Pointers to the kernels' scratch for a launch of ns splits on
    ``stream``: acc (B, H, ns, hd), m and l (B, H, ns), the f32 split
    state each launch writes before it reads it, and the (B, KV,
    ceil(G / 16)) tickets, zero between launches (the last block of each
    group resets its own).  Drawn once a stream and kept, grown when a
    launch needs more, because launches on one stream never overlap (both
    kernels share them); keeping them spares every decode step two
    allocations on the host."""
    cells = B * H * ns                   # (request, head, split)
    n_tickets, n_state = B * KV * -(-(H // KV) // 16), cells * (hd + 2)
    key = (device, stream)
    tickets, state = _SCRATCH.get(key, (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 1024), dtype=torch.int32,
                              device=device)
    if state is None or state.numel() < n_state:
        state = torch.empty(n_state, dtype=torch.float32, device=device)
    _SCRATCH[key] = (tickets, state)
    acc = state.data_ptr()
    return (acc, acc + 4 * cells * hd, acc + 4 * cells * (hd + 1),
            tickets.data_ptr())


def _decode_kernel(q, k, v, kv_len) -> torch.Tensor:
    B, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    per_request = isinstance(kv_len, torch.Tensor) and kv_len.dim() == 1
    lens = kv_len.data_ptr() if per_request else None      # NULL: scalar
    scalar = 0 if per_request else min(int(kv_len), T)
    R = kernel_split_rows(T, B * KV)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    acc, m, l, tickets = _split_state(q.device, stream, B, H, KV, hd,
                                      -(-T // R))
    build.launch(DECODE, _DECODE_ARGS, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), lens, out.data_ptr(), acc, m, l, tickets, B,
                 H, KV, hd, T, scalar, R, 1.0 / math.sqrt(hd),
                 _DTYPE_CODES[q.dtype], stream, device=q.device)
    LAUNCHES[DECODE] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """q (B, H, hd); k/v (B, T, KV, hd); ``kv_len`` an int, or a (B,)
    int32 tensor of per-request lengths, counting the cache rows each
    request attends (clamped to T).  Returns (B, H, hd) in q's dtype."""
    build.no_grad_operands(DECODE, q, k, v)
    _check_decode(q, k, v, kv_len)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"{DECODE}: no kernel for device {q.device}")
    return _decode_kernel(q, k, v, kv_len)
