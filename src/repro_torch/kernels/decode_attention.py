"""Paged flash-decode: the wrapper around the CUDA kernel and its plain
PyTorch version (twin of ``repro.kernels.decode_attention``'s
``paged_decode_attention``).

The paged serve engine runs this once per layer on every decode tick:
each request's pending token attends the first ``kv_len[b]`` rows of its
cache, read from pool blocks ``block_tables[b, 0 .. ceil(kv_len/page))``.

* On a CUDA tensor :func:`paged_decode_attention` launches the kernel in
  ``csrc/paged_decode_attention.cu`` (built on first use) or raises.
* On a CPU tensor it runs :func:`paged_decode_attention_plain`, the same
  page loop written with PyTorch ops: same page order, same masks, same
  f32 online softmax and the same roundings to V's dtype.  The CPU tests
  hold it against the reference's Pallas kernel in interpret mode, and
  ``chip_smoke.py`` holds the CUDA kernel against it on the card.

``LAUNCHES`` counts kernel launches (plain runs are not counted), so a
run can show that its decode ticks went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import build

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "LAUNCHES"]

NAME = "paged_decode_attention"
LAUNCHES: Dict[str, int] = {NAME: 0}

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
    lib = build.load(NAME)
    fn = lib.paged_decode_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    B, H, hd = q.shape
    page, KV = k_pool.shape[1], k_pool.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                 B, H, KV, hd, page, block_tables.shape[1],
                 1.0 / math.sqrt(hd), _DTYPE_CODES[q.dtype], stream)
    if err:
        lib.paged_decode_attention_error_string.restype = ctypes.c_char_p
        lib.paged_decode_attention_error_string.argtypes = [ctypes.c_int]
        msg = lib.paged_decode_attention_error_string(err).decode()
        raise RuntimeError(f"{NAME}: kernel launch failed: {msg} ({err})")
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
