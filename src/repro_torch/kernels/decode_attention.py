"""Flash-decode: the wrappers around the two CUDA decode kernels and their
plain PyTorch versions (twin of ``repro.kernels.decode_attention``).

Each request's one new token attends the first ``kv_len[b]`` rows of its
cache, its G = H / KV query heads of a group together:

* :func:`decode_attention` reads a contiguous (B, T, KV, hd) cache; the
  sync serve engine runs it once per layer on every decode step;
* :func:`paged_decode_attention` reads pool blocks
  ``block_tables[b, 0 .. ceil(kv_len/page))``; the paged serve engine
  runs it once per layer on every decode tick.

On a CUDA tensor each wrapper launches its kernel
(``csrc/decode_attention.cu``, ``csrc/paged_decode_attention.cu``, which
share their loop through ``csrc/attention_common.cuh``; built on first
use) or raises.  On a CPU tensor it runs its plain version, the same tile
loop written with PyTorch ops: same tile order, same masks, same f32
online softmax and the same roundings to V's dtype.  The CPU tests hold
the plain versions against the reference's Pallas kernels in interpret
mode, and ``chip_smoke.py`` holds the CUDA kernels against them on the
card.

``LAUNCHES`` counts kernel launches by kernel name (plain runs are not
counted), so a run can show that its decode steps went through the
kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Union

import torch

from repro_torch.kernels import build

__all__ = ["decode_attention", "decode_attention_plain",
           "paged_decode_attention", "paged_decode_attention_plain",
           "LAUNCHES", "TILE"]

NAME = "paged_decode_attention"
DECODE = "decode_attention"
LAUNCHES: Dict[str, int] = {DECODE: 0, NAME: 0}
TILE = 64             # cache rows per step of the contiguous kernel (kTile)

_NEG_INF = -0.7 * torch.finfo(torch.float32).max
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HD = 256


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, kv_len):
    """The kernel's page loop in PyTorch ops, vectorised over requests and
    KV heads.  A request whose pages are exhausted keeps its state while
    longer requests go on, as the kernel's per-request page count does;
    rows past ``kv_len`` are masked and their V rows zeroed, so stale or
    poisoned rows never reach the result."""
    B, H, hd = q.shape
    page, KV = k_pool.shape[1], k_pool.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    lens = kv_len.to(device=dev, dtype=torch.long)
    tables = block_tables.to(device=dev, dtype=torch.long)
    qf = q.reshape(B, KV, G, hd).float() * scale
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
        s = torch.einsum("bkgd,btkd->bkgt", qf, k)
        s = torch.where(valid[:, None, None, :], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1, keepdim=True)
        pv = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(), v.float())
        acc_new = acc * corr + pv.to(v.dtype).float()
        live = (j * page < lens)[:, None, None, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype).reshape(B, H, hd)


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
    if hd % 32 or hd > _MAX_HD:
        raise ValueError(f"{NAME}: head dim {hd} must be a multiple of 32 "
                         f"and at most {_MAX_HD}")
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
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        build.launch(NAME, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
                     q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                     block_tables.data_ptr(), kv_len.data_ptr(),
                     out.data_ptr(), B, H, KV, hd, page,
                     block_tables.shape[1], 1.0 / math.sqrt(hd),
                     _DTYPE_CODES[q.dtype],
                     torch.cuda.current_stream(q.device).cuda_stream)
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


def decode_attention_plain(q, k, v, kv_len, *,
                           block_kv: int = TILE) -> torch.Tensor:
    """The kernel's tile loop in PyTorch ops: request b's cache is walked
    in tiles of ``block_kv`` rows, which is the paged loop over a pool
    whose page is the tile and whose table lists b's tiles in order (the
    cache's ragged tail is zero-padded to a whole tile and masked)."""
    B, T, KV, hd = k.shape
    nt = -(-T // block_kv)
    pad = nt * block_kv - T
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    tables = torch.arange(B * nt, dtype=torch.int32,
                          device=q.device).reshape(B, nt)
    return paged_decode_attention_plain(
        q, k.reshape(B * nt, block_kv, KV, hd),
        v.reshape(B * nt, block_kv, KV, hd), tables,
        _lens(kv_len, B, T, q.device))


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
    if hd % 32 or hd > _MAX_HD:
        raise ValueError(f"{DECODE}: head dim {hd} must be a multiple of 32 "
                         f"and at most {_MAX_HD}")
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


def _decode_kernel(q, k, v, kv_len) -> torch.Tensor:
    B, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    per_request = isinstance(kv_len, torch.Tensor) and kv_len.dim() == 1
    lens = kv_len.data_ptr() if per_request else None      # NULL: scalar
    scalar = 0 if per_request else min(int(kv_len), T)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        build.launch(DECODE, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
                     q.data_ptr(), k.data_ptr(), v.data_ptr(), lens,
                     out.data_ptr(), B, H, KV, hd, T, scalar,
                     1.0 / math.sqrt(hd), _DTYPE_CODES[q.dtype],
                     torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES[DECODE] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """q (B, H, hd); k/v (B, T, KV, hd); ``kv_len`` an int, or a (B,)
    int32 tensor of per-request lengths, counting the cache rows each
    request attends (clamped to T).  Returns (B, H, hd) in q's dtype."""
    _check_decode(q, k, v, kv_len)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"{DECODE}: no kernel for device {q.device}")
    return _decode_kernel(q, k, v, kv_len)
