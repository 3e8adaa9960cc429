"""Causal GQA flash attention: the wrapper around the CUDA kernel and its
plain PyTorch version (twin of ``repro.kernels.flash_attention``).

The sync serve engine runs this once per layer on every prefill: q
(B, S, H, hd) attends k/v (B, T, KV, hd), H = KV * G query heads over KV
heads, causally or not, with key rows at or past ``kv_len`` masked.

* On a CUDA tensor :func:`flash_attention` launches the kernel in
  ``csrc/flash_attention.cu`` (built on first use) or raises: for bf16
  and f16, FlashAttention-2's shape on the tensor cores (``mma.sync``,
  64-row K/V tiles through a cp.async ring, p as a high and a low half so
  that it keeps f32's precision); for f32, a CUDA-core kernel.
* On a CPU tensor it runs :func:`flash_attention_plain`, the same tile
  loop written with PyTorch ops: same tile order, same masks, same f32
  online softmax.  Scores are ``(q . k) * scale``, as the kernel forms
  them (bf16 products are exact on the tensor cores); the reference
  scales q first, and the two differ by f32 rounding only.  p and each
  tile's PV product stay f32, where the reference rounds both to V's
  dtype: only the output is rounded, as in the model's plain path
  (``models.attention._flash_sdpa``).  The CPU tests
  hold it against the reference's Pallas kernel in interpret mode (at
  the reference plan's ``block_kv``), and ``chip_smoke.py`` holds the
  CUDA kernel against it on the card (at the kernel's own tile).

Ragged S and T need no padding: the kernel masks them itself, which
computes what the reference's pad, mask and slice wrapper
(``repro.kernels.ops.flash_attention``) computes.

``LAUNCHES`` counts kernel launches (plain runs are not counted), so a
run can show that its prefills went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import build

__all__ = ["flash_attention", "flash_attention_plain", "LAUNCHES", "TILE"]

NAME = "flash_attention"
LAUNCHES: Dict[str, int] = {NAME: 0}
TILE = 64                       # key rows per step of the CUDA kernel (kBKV)
QUERY_ROWS = 64                 # query rows a block (kBQ, the .cu:77)
STAGES = 2                      # K, V tiles in flight on tensor cores (:86)
HEAD_DIMS = (32, 64, 128)       # the head dims the kernels are built for

_NEG_INF = -0.7 * torch.finfo(torch.float32).max
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, kv_len: Optional[int] = None,
                          block_kv: int = TILE) -> torch.Tensor:
    """The kernel's tile loop in PyTorch ops, vectorised over requests,
    heads and query rows, walking the keys in tiles of ``block_kv`` rows.

    Tiles wholly past ``kv_len`` or wholly above the diagonal of the last
    query row are skipped, as the kernel skips them; a tile that is fully
    masked for some rows only leaves those rows' state as it was, so the
    kernel's per-query-tile skips change nothing."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    n = T if kv_len is None else max(0, min(int(kv_len), T))
    scale = 1.0 / math.sqrt(hd)
    # (B, KV, G, S, hd); scores are (q . k) * scale, as in the kernel
    qf = q.reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4).float()
    m = torch.full((B, KV, G, S, 1), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, KV, G, S, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, S, hd), dtype=torch.float32, device=dev)
    n_tiles = -(-n // block_kv)
    if causal:
        n_tiles = min(n_tiles, (S - 1) // block_kv + 1)
    rows = torch.arange(S, device=dev)[:, None]
    for j in range(n_tiles):
        t0, t1 = j * block_kv, min((j + 1) * block_kv, n)
        kt = k[:, t0:t1].permute(0, 2, 1, 3).float()          # (B,KV,w,hd)
        vt = v[:, t0:t1].permute(0, 2, 1, 3)
        s = torch.einsum("bkgsd,bktd->bkgst", qf, kt) * scale
        if causal:
            cols = torch.arange(t0, t1, device=dev)[None, :]
            s = torch.where(cols <= rows, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = torch.einsum("bkgst,bktd->bkgsd", p, vt.float())
        acc = acc * corr + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"{NAME}: want q (B, S, H, hd) and k/v (B, T, KV, hd) of one "
            f"shape, got q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} does not group over "
                         f"k/v {tuple(k.shape)} (batch, head dim, H % KV)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {hd} not in {HEAD_DIMS}")
    if min(B, S, T) < 1:
        raise ValueError(f"{NAME}: empty operand: B={B}, S={S}, T={T}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{NAME}: q/k/v must share one of "
                         f"{list(_DTYPE_CODES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{NAME}: all operands must be on {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{NAME}: operands must be contiguous")


def _kernel(q, k, v, causal: bool, kv_len: int) -> torch.Tensor:
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    build.launch(NAME, _ARGS, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), B, S, T, H, KV, hd, kv_len, int(causal),
                 1.0 / math.sqrt(hd), _DTYPE_CODES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream,
                 device=q.device)
    LAUNCHES[NAME] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, hd); k/v (B, T, KV, hd) with H = KV * G; ``kv_len`` an
    int (default T) masking key rows at or past it.  Returns
    (B, S, H, hd) in q's dtype.  The causal mask is ``key <= query``
    with both counted from row 0, as in the reference kernel."""
    build.no_grad_operands(NAME, q, k, v)
    _check(q, k, v)
    T = k.shape[1]
    n = T if kv_len is None else max(0, min(int(kv_len), T))
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, kv_len=n)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {q.device}")
    return _kernel(q, k, v, causal, n)
