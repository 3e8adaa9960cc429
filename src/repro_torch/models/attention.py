"""GQA self-attention over the block-paged KV pool
(twin of the GQA half of ``repro.models.attention``).

Ported: ``init_attn``, ``_qkv``, ``sdpa`` and the two paged layer steps
the serve engine runs, :func:`attn_decode_paged` (one token per request)
and :func:`attn_prefill_paged` (one prompt chunk).  MLA, cross-attention
and the contiguous-cache steps are later slices (ROADMAP queue 1).

Pool writes happen in place: the pools are ``(P, page, KV, hd)`` views
into the engine's per-layer pool tensors, and the new K/V rows are
index-written into them.  The reference returns updated pools and its
engine donates the old ones so XLA can reuse their buffers; the result
is the same.

With ``cfg.use_kernels`` the decode step calls
:func:`repro_torch.kernels.paged_decode_attention` (the CUDA kernel on
CUDA tensors, its plain version on CPU tensors); otherwise it gathers
each request's pages into a dense cache and runs :func:`sdpa`, the
reference's ``use_pallas=False`` path.  Paged prefill always gathers and
runs :func:`sdpa` (matmul plus f32 softmax), as the reference does.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import paged_decode_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cdtype, dense, mm, rope

__all__ = ["init_attn", "sdpa", "attn_decode_paged", "attn_prefill_paged"]

_NEG_INF = -0.7 * torch.finfo(torch.float32).max


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
         scale: float, kv_len=None, q_offset=0) -> torch.Tensor:
    """Plain attention over full heads.  q: (B,S,H,hd); k/v: (B,T,H,hd).
    ``kv_len`` is an int or a per-request (B,) vector; ``q_offset``, the
    global index of q's first row for the causal mask, likewise."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    dev = q.device
    logits = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * scale  # (B,H,S,T)
    if causal and S > 1:
        j = torch.arange(T, device=dev)[None, :]
        i = torch.arange(S, device=dev)[:, None]
        qo = torch.as_tensor(q_offset, device=dev)
        if qo.dim() == 1:
            keep = j[None, None] <= i[None, None] + qo[:, None, None, None]
        else:
            keep = (j <= i + qo)[None, None]
        logits = torch.where(keep, logits, _NEG_INF)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=dev)
        if kl.dim() == 1:
            kl = kl[:, None, None, None]
        logits = torch.where(torch.arange(T, device=dev) < kl, logits,
                             _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = mm(probs, v.transpose(1, 2), out_dtype=q.dtype)           # (B,H,S,hd)
    return out.transpose(1, 2)


def init_attn(cfg: ModelConfig, gen: torch.Generator,
              device: torch.device) -> Dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cdtype(cfg)
    s = 1.0 / math.sqrt(D)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dt)

    w = {"wq": normal((D, H * hd), s),
         "wk": normal((D, KV * hd), s),
         "wv": normal((D, KV * hd), s),
         "wo": normal((H * hd, D), s / math.sqrt(max(1, cfg.n_layers)))}
    if cfg.qkv_bias:
        w["bq"] = torch.zeros((H * hd,), dtype=dt, device=device)
        w["bk"] = torch.zeros((KV * hd,), dtype=dt, device=device)
        w["bv"] = torch.zeros((KV * hd,), dtype=dt, device=device)
    return w


def _qkv(cfg: ModelConfig, w, x, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = dense(x, w["wq"], w.get("bq")).reshape(B, S, H, hd)
    k = dense(x, w["wk"], w.get("bk")).reshape(B, S, KV, hd)
    v = dense(x, w["wv"], w.get("bv")).reshape(B, S, KV, hd)
    if cfg.pos_embed == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gather_heads(cfg: ModelConfig, pool: torch.Tensor,
                  tables: torch.Tensor) -> torch.Tensor:
    """Gather the tables' pages into a dense (B, NB*page, H, hd) cache,
    each KV head repeated over its G query heads."""
    B = tables.shape[0]
    KV, hd = pool.shape[2], pool.shape[3]
    dense_kv = pool[tables.long()].reshape(B, -1, KV, hd)
    return dense_kv.repeat_interleave(cfg.n_heads // KV, dim=2)


def attn_decode_paged(cfg: ModelConfig, w, x: torch.Tensor, cache: Dict,
                      block_tables: torch.Tensor,
                      lens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One continuous-batching decode step against the shared KV pool.

    x: (B, 1, D), each row a different request's pending token; cache
    ``{"k", "v"}``: (P, page, KV, hd) pools, written in place;
    block_tables: (B, NB) int32 (unused tail slots hold null block 0);
    lens: (B,) int32 tokens already cached per request, which is both
    the new token's write position and its RoPE position."""
    B, S, D = x.shape
    q, k_new, v_new = _qkv(cfg, w, x, lens[:, None])
    P, page, KV, hd = cache["k"].shape
    # the new row lands in block table[b, lens // page] at row lens % page;
    # requests own disjoint blocks, idle slots all hit the null block
    slot = torch.gather(block_tables, 1, (lens // page)[:, None].long())[:, 0]
    idx = slot.long() * page + (lens % page).long()
    cache["k"].view(P * page, KV, hd)[idx] = k_new[:, 0]
    cache["v"].view(P * page, KV, hd)[idx] = v_new[:, 0]
    kv_len = lens + 1
    if cfg.use_kernels:
        out = paged_decode_attention(q[:, 0], cache["k"], cache["v"],
                                     block_tables, kv_len)[:, None]
    else:
        out = sdpa(q, _gather_heads(cfg, cache["k"], block_tables),
                   _gather_heads(cfg, cache["v"], block_tables),
                   causal=False, scale=1.0 / math.sqrt(hd), kv_len=kv_len)
    y = dense(out.reshape(B, S, cfg.n_heads * hd), w["wo"])
    return y, cache


def attn_prefill_paged(cfg: ModelConfig, w, x: torch.Tensor, cache: Dict,
                       block_tables: torch.Tensor, lens: torch.Tensor,
                       n_valid: torch.Tensor, *,
                       aligned: bool = False) -> Tuple[torch.Tensor, Dict]:
    """One continuation-prefill chunk against the shared KV pool.

    x: (B, C, D), a chunk of each request's uncached prompt suffix,
    right-padded past ``n_valid``; ``lens`` (B,) is the chunk's global
    start position.  The chunk's K/V rows are written into the pools
    first; attention then reads the whole table back as a dense cache,
    causal at each request's own offset.

    ``aligned=True`` promises B == 1 and a chunk inside one block (the
    engine's case when the chunk size divides the page): the rows go to
    one contiguous window, padded rows just past the valid prefix inside
    the request's own block, where ``kv_len`` masks them and decode
    overwrites them before they are read.  Otherwise each row is
    scattered to its position and padded rows go to the null block."""
    B, C, D = x.shape
    dev = x.device
    row = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    positions = lens[:, None] + row
    q, k_new, v_new = _qkv(cfg, w, x, positions)
    P, page, KV, hd = cache["k"].shape
    NB = block_tables.shape[1]
    if aligned and B == 1 and C <= page:
        start = block_tables[0, lens[0] // page].long() * page \
            + (lens[0] % page).long()
        idx = start + row[0].long()
    else:
        blk = torch.gather(block_tables, 1,
                           (positions // page).clamp(max=NB - 1).long())
        idx = blk.long() * page + (positions % page).long()
        idx = torch.where(row < n_valid[:, None], idx, (row % page).long())
    idx = idx.reshape(-1)
    cache["k"].view(P * page, KV, hd)[idx] = k_new.reshape(B * C, KV, hd)
    cache["v"].view(P * page, KV, hd)[idx] = v_new.reshape(B * C, KV, hd)
    out = sdpa(q, _gather_heads(cfg, cache["k"], block_tables),
               _gather_heads(cfg, cache["v"], block_tables), causal=True,
               scale=1.0 / math.sqrt(hd), kv_len=lens + n_valid,
               q_offset=lens)
    y = dense(out.reshape(B, C, cfg.n_heads * hd), w["wo"])
    return y, cache
