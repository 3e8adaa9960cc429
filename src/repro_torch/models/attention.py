"""Attention mixers: GQA self-attention, MLA (DeepSeek-V2) and
cross-attention (twin of ``repro.models.attention``).

Ported: ``init_attn``, ``_qkv``, the attention math (:func:`sdpa`,
:func:`_flash_sdpa`, :func:`_causal_split_flash` and the
:func:`attention` entry point with its kernel dispatch), the
contiguous-cache layer steps the sync serve engine runs
(:func:`attn_train`, :func:`init_attn_cache`, :func:`attn_decode`), the
two paged layer steps the paged engine runs, :func:`attn_decode_paged`
(one token per request) and :func:`attn_prefill_paged` (one prompt
chunk), Multi-head Latent Attention (:func:`init_mla`,
:func:`mla_train`, :func:`init_mla_cache`, :func:`mla_decode`: the cache
holds the compressed latent and the decoupled RoPE key, up-projected at
every use) and cross-attention over media or encoder embeddings
(:func:`init_cross`, :func:`cross_kv`, :func:`cross_train`,
:func:`cross_decode`).

Caches are written in place: :func:`attn_decode` writes the new row into
the (B, max_len, KV, hd) cache tensors it is given, :func:`mla_decode`
its latent and RoPE-key rows, and the paged steps index-write their rows
into the ``(P, page, KV, hd)`` pools.  The reference returns updated
caches and its engines donate the old ones so XLA can reuse their
buffers; the result is the same.

With ``cfg.use_kernels`` :func:`attention` calls the port's kernels
(the CUDA kernel on CUDA tensors, its plain version on CPU tensors):
:func:`repro_torch.kernels.flash_attention` when S > 1 and
:func:`repro_torch.kernels.decode_attention` for the single-token step,
causal or not (cross-attention attends every media row).  There is no
fallback: what the kernels cannot take (a value head dim other than the
query's, or a softmax scale other than 1/sqrt(hd)) raises
``NotImplementedError``.  MLA never asks: its value head differs from its
query head, so the reference's dispatch always gave it the plain path,
and :func:`_mla_attend` calls that path itself.  Otherwise
:func:`attention` runs the reference's ``use_pallas=False`` path:
:func:`sdpa` below 2048 keys, the blockwise :func:`_flash_sdpa` from 2048
keys on (S > 1).  The paged decode step calls
:func:`repro_torch.kernels.paged_decode_attention` with
``cfg.use_kernels``, else gathers each request's pages into a dense
cache and runs :func:`sdpa`; paged prefill always gathers and runs
:func:`sdpa`, as the reference does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import (decode_attention, flash_attention,
                                 paged_decode_attention)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (DTYPES, cdtype, dense, mm,
                                       model_axis, norm_apply, rope)
from repro_torch.parallel.api import (current_mesh, is_dtensor,
                                      named_sharding, shard, write_rows)

__all__ = ["init_attn", "attn_train", "attn_decode", "attn_decode_paged",
           "attn_prefill_paged", "init_mla", "mla_train", "mla_decode",
           "init_cross", "cross_kv", "cross_train", "cross_decode",
           "init_attn_cache", "init_mla_cache", "sdpa", "attention"]

_FLASH_BLOCK = 512
_FLASH_MIN_T = 2048     # plain sdpa below this KV length
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


def _kv_len_bc(kv_len, device) -> torch.Tensor:
    """``kv_len`` for (B, H, S, T) logits masks: a scalar broadcasts as
    is; a per-request (B,) vector gains (1, 1, 1) tails."""
    kl = torch.as_tensor(kv_len, device=device)
    return kl[:, None, None, None] if kl.dim() == 1 else kl


def _flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, scale: float, kv_len=None, q_offset: int = 0,
                block: int = _FLASH_BLOCK) -> torch.Tensor:
    """Blockwise online-softmax attention over KV blocks of ``block``
    rows, the reference's long-sequence path: f32 scores, running max,
    denominator and accumulator.  k/v may carry KV < H heads; they are
    expanded per block.  ``q_offset`` is the global row of q's first
    position for the causal mask."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    if T % block:
        pad = block - T % block
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_len = T if kv_len is None else kv_len
        T = T + pad
    if kv_len is not None:
        kv_len = _kv_len_bc(kv_len, dev)
    qf = q.float() * scale
    hd_v = v.shape[-1]
    m = torch.full((B, H, S), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, S, hd_v), dtype=torch.float32, device=dev)
    row = torch.arange(S, device=dev)[None, None, :, None] + q_offset
    for ib in range(T // block):
        kb = k[:, ib * block:(ib + 1) * block]
        vb = v[:, ib * block:(ib + 1) * block]
        if G > 1:
            kb = kb.repeat_interleave(G, dim=2)
            vb = vb.repeat_interleave(G, dim=2)
        s = torch.einsum("bshd,bthd->bhst", qf, kb.float())
        col = torch.arange(block, device=dev)[None, None, None, :] \
            + ib * block
        if causal and S > 1:
            s = torch.where(col <= row, s, _NEG_INF)
        if kv_len is not None:
            s = torch.where(col < kv_len, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bthd->bhsd", p,
                                                   vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _attention_kernel(q, k, v, *, causal: bool, scale: float,
                      kv_len) -> torch.Tensor:
    """The kernel path: ``flash_attention`` for S > 1 (train/prefill),
    ``decode_attention`` for the S == 1 cache step.  What the kernels
    cannot take raises instead of falling back."""
    B, S, H, hd = q.shape
    kernel = "flash_attention" if S > 1 else "decode_attention"
    if v.shape[-1] != hd:
        raise NotImplementedError(
            f"{kernel}: value head dim {v.shape[-1]} != query head dim {hd} "
            "(MLA-style asymmetric heads) has no kernel; the reference's "
            "dispatch runs such heads on its plain path")
    if abs(scale * math.sqrt(hd) - 1.0) > 1e-6:
        raise NotImplementedError(
            f"{kernel}: softmax scale {scale:g} != 1/sqrt(hd) has no kernel; "
            "the reference's dispatch runs it on its plain path")
    if S > 1:
        return flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    kl = k.shape[1] if kv_len is None else kv_len
    return decode_attention(q[:, 0], k, v, kl)[:, None]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, scale: Optional[float] = None, kv_len=None,
              use_kernels: bool = False) -> torch.Tensor:
    """Grouped attention entry point.  q: (B,S,H,hd); k/v: (B,T,KV,hd).

    With ``use_kernels`` the port's kernels run (see the module
    docstring).  Otherwise the reference's plain path: the blockwise
    :func:`_flash_sdpa` for T >= 2048 and S > 1 (triangle-split when a
    causal self-attention is long enough), plain :func:`sdpa` over KV
    heads repeated to H otherwise."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if use_kernels:
        return _attention_kernel(q, k, v, causal=causal, scale=scale,
                                 kv_len=kv_len)
    if S > 1 and is_dtensor(q):
        return _attention_on_shards(q, k, v, causal=causal, scale=scale,
                                    kv_len=kv_len)
    use_flash = T >= _FLASH_MIN_T and S > 1
    if use_flash:
        if causal and S == T and kv_len is None and S >= 2 * _FLASH_MIN_T:
            return _causal_split_flash(q, k, v, scale=scale, depth=2)
        return _flash_sdpa(q, k, v, causal=causal, scale=scale,
                           kv_len=kv_len)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    return sdpa(q, k, v, causal=causal, scale=scale, kv_len=kv_len)


def _attention_on_shards(q, k, v, *, causal: bool, scale: float,
                         kv_len) -> torch.Tensor:
    """The plain path for S > 1 under a mesh, run on each rank's block
    with ``local_map`` (DTensor ops inside the blockwise loops would cost
    a dispatch each).  The layout is the reference's at its attention
    core: heads on the model axis when both head counts divide it, else
    query rows (``seq_tp``) with K/V whole; batch on its axes.  A rank's
    causal mask starts at its first query row."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = current_mesh()
    B, S, H, hd = q.shape
    by_heads = H % model_axis() == 0 and k.shape[2] % model_axis() == 0
    q_axes = ("batch", None, "heads", None) if by_heads \
        else ("batch", "seq_tp", None, None)
    kv_axes = ("batch", None, "heads" if by_heads else None, None)
    q_pl = named_sharding(q.shape, q_axes, mesh)
    kv_pl = named_sharding(k.shape, kv_axes, mesh)
    offset, rows, coord = 0, 1, mesh.get_coordinate()
    for m, pl in enumerate(q_pl):
        if isinstance(pl, Shard) and pl.dim == 1:
            offset, rows = offset * mesh.size(m) + coord[m], \
                rows * mesh.size(m)
    offset *= S // rows

    def body(ql, kl, vl):
        if offset == 0:
            return attention(ql, kl, vl, causal=causal, scale=scale,
                             kv_len=kv_len)
        if kl.shape[1] >= _FLASH_MIN_T:
            return _flash_sdpa(ql, kl, vl, causal=causal, scale=scale,
                               kv_len=kv_len, q_offset=offset)
        G = ql.shape[2] // kl.shape[2]
        return sdpa(ql, kl.repeat_interleave(G, dim=2),
                    vl.repeat_interleave(G, dim=2), causal=causal,
                    scale=scale, kv_len=kv_len, q_offset=offset)

    return local_map(body, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def _causal_split_flash(q, k, v, *, scale: float, depth: int,
                        q_offset: int = 0) -> torch.Tensor:
    """Causal triangle splitting: the low half of q attends only the low
    half of K/V, the high half all of it, which skips the fully masked
    blocks a uniform scan would run."""
    S = q.shape[1]
    if depth == 0 or S < 2 * _FLASH_MIN_T or S % 2:
        return _flash_sdpa(q, k, v, causal=True, scale=scale,
                           q_offset=q_offset)
    h = S // 2
    lo = _causal_split_flash(q[:, :h], k[:, :h], v[:, :h], scale=scale,
                             depth=depth - 1, q_offset=q_offset)
    hi = _flash_sdpa(q[:, h:], k, v, causal=True, scale=scale,
                     q_offset=q_offset + h)
    return torch.cat([lo, hi], dim=1)


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


def _heads(t: torch.Tensor, n: int, hd: int, *, query: bool
           ) -> torch.Tensor:
    """A projection (B, S, n * hd) as (B, S, n, hd).  Under a mesh its
    last dim is laid out on whole heads first, as :func:`_shard_q` and
    :func:`_shard_kv` lay out the result (a model-axis split of n * hd
    that cuts through a head cannot be viewed as heads): on ``heads``
    when n divides the model axis, else replicated, with query rows on
    ``seq_tp`` for a query."""
    B, S = t.shape[:2]
    if n % model_axis() == 0:
        t = shard(t, "batch", None, "heads")
    else:
        t = shard(t, "batch", "seq_tp" if query else None, None)
    return t.reshape(B, S, n, hd)


def _merge_heads(out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, H * hd), laid out under a mesh as
    :func:`_heads` lays out a query projection, so the gradient that
    comes back through the output projection is laid out so too (a
    model-axis split of H * hd that cuts through a head cannot be viewed
    back as heads)."""
    B, S, H, hd = out.shape
    flat = out.reshape(B, S, H * hd)
    if H % model_axis() == 0:
        return shard(flat, "batch", None, "heads")
    return shard(flat, "batch", "seq_tp", None)


def _shard_q(q: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd): heads-TP when divisible, else sequence-TP."""
    if q.shape[2] % model_axis() == 0:
        return shard(q, "batch", None, "heads", None)
    return shard(q, "batch", "seq_tp", None, None)


def _shard_kv(k: torch.Tensor) -> torch.Tensor:
    """(B, T, KV, hd) train-time K/V: batch-sharded, heads when
    divisible."""
    heads = "heads" if k.shape[2] % model_axis() == 0 else None
    return shard(k, "batch", None, heads, None)


CACHE_AXES = ("batch", "kv_seq", None, None)    # (B, T, KV, hd) K/V caches
MLA_CACHE_AXES = ("batch", "kv_seq", None)      # (B, T, r) latent caches


def _qkv(cfg: ModelConfig, w, x, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _heads(dense(x, w["wq"], w.get("bq")), H, hd, query=True)
    k = _heads(dense(x, w["wk"], w.get("bk")), KV, hd, query=False)
    v = _heads(dense(x, w["wv"], w.get("bv")), KV, hd, query=False)
    if cfg.pos_embed == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return _shard_q(q), _shard_kv(k), _shard_kv(v)


def attn_train(cfg: ModelConfig, w, x: torch.Tensor,
               positions: torch.Tensor, *, causal: bool = True
               ) -> torch.Tensor:
    """Full-sequence self-attention: x (B, S, D) at ``positions``."""
    q, k, v = _qkv(cfg, w, x, positions)
    out = _shard_q(attention(q, k, v, causal=causal,
                             use_kernels=cfg.use_kernels))
    return dense(_merge_heads(out), w["wo"])


def _cache_dtype(cfg: ModelConfig, dtype) -> torch.dtype:
    """``dtype`` (a ``torch.dtype`` or its name), or ``cfg.dtype`` when
    None."""
    if dtype is None:
        return cdtype(cfg)
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                    *, device: Union[str, torch.device]) -> Dict:
    """Zeroed (batch, max_len, KV, hd) K and V caches in ``dtype`` (a
    ``torch.dtype`` or its name; ``cfg.dtype`` when None)."""
    shp = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    dt = _cache_dtype(cfg, dtype)
    return {"k": torch.zeros(shp, dtype=dt, device=device),
            "v": torch.zeros(shp, dtype=dt, device=device)}


def attn_decode(cfg: ModelConfig, w, x: torch.Tensor, cache: Dict,
                pos: int) -> Tuple[torch.Tensor, Dict]:
    """One decode step: x (B, 1, D) is every request's new token at
    position ``pos`` (an int, the number of rows already cached).  Its
    K/V row is written into ``cache`` in place; attention then reads rows
    [0, pos + 1)."""
    B, S, D = x.shape
    pos = int(pos)
    positions = torch.full((S,), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(cfg, w, x, positions)
    write_rows(cache["k"], 1, pos, k_new)
    write_rows(cache["v"], 1, pos, v_new)
    out = attention(q, shard(cache["k"], *CACHE_AXES),
                    shard(cache["v"], *CACHE_AXES), causal=False,
                    kv_len=pos + 1, use_kernels=cfg.use_kernels)
    y = dense(_merge_heads(out), w["wo"])
    return y, cache


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


# -- MLA: Multi-head Latent Attention (DeepSeek-V2) ---------------------------

def init_mla(cfg: ModelConfig, gen: torch.Generator,
             device: torch.device) -> Dict:
    """The query projection, the down-projection to the latent and the
    decoupled RoPE key, the latent's up-projections to the keys' no-RoPE
    part and the values, the output projection and the latent's norm;
    the reference's initialisation scales."""
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    dt = cdtype(cfg)
    s = 1.0 / math.sqrt(D)
    sl = 1.0 / math.sqrt(m.kv_lora_rank)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dt)

    return {"wq": normal((D, H * qk), s),
            "w_dkv": normal((D, m.kv_lora_rank + m.qk_rope_dim), s),
            "w_uk": normal((m.kv_lora_rank, H * m.qk_nope_dim), sl),
            "w_uv": normal((m.kv_lora_rank, H * m.v_head_dim), sl),
            "wo": normal((H * m.v_head_dim, D),
                         s / math.sqrt(max(1, cfg.n_layers))),
            "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dt,
                                  device=device)}


def _mla_latent(cfg: ModelConfig, w, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> the normed latent c_kv (B, S, kv_lora_rank) and the
    decoupled key k_rope (B, S, qk_rope_dim), rotated at ``positions``:
    what the cache holds."""
    r = cfg.mla.kv_lora_rank
    dkv = dense(x, w["w_dkv"])
    c_kv = norm_apply(cfg, w["kv_norm"], dkv[..., :r])
    k_rope = rope(dkv[..., r:][:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_attend(cfg: ModelConfig, w, x: torch.Tensor, c_kv: torch.Tensor,
                k_rope: torch.Tensor, positions: torch.Tensor, *,
                causal: bool, kv_len=None) -> torch.Tensor:
    """Queries of x (B, S, D) against keys and values up-projected from
    the latent c_kv (B, T, r), the one RoPE key shared by every head.

    Attention runs the plain path whatever ``cfg.use_kernels`` says: the
    query/key head (qk_nope + qk_rope) and the value head differ, and the
    reference's kernel dispatch (``repro.models.attention``, lines
    195-199 of ``_attention_kernel``) sends such heads to its plain path,
    so no TPU kernel ever computed MLA's attention."""
    m = cfg.mla
    B, S = x.shape[:2]
    T, H = c_kv.shape[1], cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    q = _heads(dense(x, w["wq"]), H, qk, query=True)
    q_rope = rope(q[..., m.qk_nope_dim:], positions, cfg.rope_theta)
    k_nope = _heads(dense(c_kv, w["w_uk"]), H, m.qk_nope_dim, query=False)
    v = _heads(dense(c_kv, w["w_uv"]), H, m.v_head_dim, query=False)
    q_full = torch.cat([q[..., :m.qk_nope_dim], q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, T, H, m.qk_rope_dim)], dim=-1)
    out = attention(q_full, k_full, v, causal=causal,
                    scale=1.0 / math.sqrt(qk), kv_len=kv_len,
                    use_kernels=False)
    return dense(_merge_heads(out), w["wo"])


def mla_train(cfg: ModelConfig, w, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal MLA: x (B, S, D) at ``positions``."""
    c_kv, k_rope = _mla_latent(cfg, w, x, positions)
    return _mla_attend(cfg, w, x, c_kv, k_rope, positions, causal=True)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                   *, device: Union[str, torch.device]) -> Dict:
    """Zeroed latent (batch, max_len, kv_lora_rank) and RoPE-key
    (batch, max_len, qk_rope_dim) caches in ``dtype`` (as in
    :func:`init_attn_cache`)."""
    m = cfg.mla
    dt = _cache_dtype(cfg, dtype)
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dt,
                               device=device),
            "krope": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dt,
                                 device=device)}


def mla_decode(cfg: ModelConfig, w, x: torch.Tensor, cache: Dict,
               pos: int) -> Tuple[torch.Tensor, Dict]:
    """One MLA decode step: x (B, 1, D) at position ``pos``.  Its latent
    and RoPE-key rows are written into ``cache`` in place; attention then
    reads rows [0, pos + 1)."""
    S = x.shape[1]
    pos = int(pos)
    positions = torch.full((S,), pos, dtype=torch.int32, device=x.device)
    c_new, kr_new = _mla_latent(cfg, w, x, positions)
    write_rows(cache["ckv"], 1, pos, c_new)
    write_rows(cache["krope"], 1, pos, kr_new)
    y = _mla_attend(cfg, w, x, shard(cache["ckv"], *MLA_CACHE_AXES),
                    shard(cache["krope"], *MLA_CACHE_AXES), positions,
                    causal=False, kv_len=pos + 1)
    return y, cache


# -- cross-attention over media or encoder embeddings -------------------------

init_cross = init_attn  # the same weights; biases, if any, are not used


def cross_kv(cfg: ModelConfig, w, media: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V (B, M, KV, hd) of media or encoder embeddings (B, M, D)."""
    KV, hd = cfg.n_kv_heads, cfg.hd
    return (_heads(dense(media, w["wk"]), KV, hd, query=False),
            _heads(dense(media, w["wv"]), KV, hd, query=False))


def cross_train(cfg: ModelConfig, w, x: torch.Tensor,
                media: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) attends every row of ``media`` (B, M, D), no mask and
    no RoPE: ``flash_attention(causal=False)`` with T = M under
    ``cfg.use_kernels``."""
    H, hd = cfg.n_heads, cfg.hd
    q = _heads(dense(x, w["wq"]), H, hd, query=True)
    k, v = cross_kv(cfg, w, media)
    out = attention(q, k, v, causal=False, use_kernels=cfg.use_kernels)
    return dense(_merge_heads(out), w["wo"])


def cross_decode(cfg: ModelConfig, w, x: torch.Tensor,
                 kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """One decode step's cross-attention against the media K/V the
    prefill cached: ``decode_attention`` over all M rows under
    ``cfg.use_kernels``."""
    H, hd = cfg.n_heads, cfg.hd
    q = _heads(dense(x, w["wq"]), H, hd, query=True)
    out = attention(q, kv[0], kv[1], causal=False,
                    use_kernels=cfg.use_kernels)
    return dense(_merge_heads(out), w["wo"])
