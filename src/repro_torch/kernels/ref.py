"""Plain oracles for the port's kernels (twin of ``repro.kernels.ref``).

Each oracle is the most obviously correct formulation (full softmax over
a dense cache, the SSM recurrence one step at a time), deliberately not
the blocked or chunked algorithm the kernels use,
so agreement checks the algebra and not just the implementation.
"""

from __future__ import annotations

import math

import torch

__all__ = ["mfma_gemm_ref", "flash_attention_ref", "decode_attention_ref",
           "paged_decode_attention_ref", "moe_gmm_ref", "mamba2_ssd_ref"]


def mfma_gemm_ref(a, b, c):
    """D = C + A @ B with f32 accumulation (the MFMA contract), in C's
    dtype."""
    return (c.float() + a.float() @ b.float()).to(c.dtype)


def _grouped_full_attn(q, k, v, *, causal, kv_len=None):
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    s = s / math.sqrt(hd)
    neg = torch.tensor(-math.inf, device=q.device)
    if causal:
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(T, device=q.device)[None, :]
        s = torch.where(j <= i, s, neg)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=q.device)
        if kl.dim() == 1:                     # per-request (B,) lengths
            kl = kl[:, None, None, None, None]
        s = torch.where(torch.arange(T, device=q.device) < kl, s, neg)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return o.reshape(B, S, H, -1).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal=True):
    """Full-softmax grouped attention (no blocking)."""
    return _grouped_full_attn(q, k, v, causal=causal)


def decode_attention_ref(q, k, v, kv_len):
    """q (B, H, hd) single-token attention vs cache prefix < kv_len
    (an int scalar, or a per-request (B,) vector)."""
    return _grouped_full_attn(q[:, None], k, v, causal=False,
                              kv_len=kv_len)[:, 0]


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, kv_len):
    """Gather each request's blocks from the (P, page, KV, hd) pools into
    a dense (B, NB*page, KV, hd) cache, then run the plain decode oracle
    with per-request lengths."""
    B = q.shape[0]
    KV, hd = k_pool.shape[2], k_pool.shape[3]
    tables = block_tables.long()
    k = k_pool[tables].reshape(B, -1, KV, hd)
    v = v_pool[tables].reshape(B, -1, KV, hd)
    return decode_attention_ref(q, k, v, kv_len)


def moe_gmm_ref(x, w):
    """(E, C, K) @ (E, K, N) -> (E, C, N), f32 accumulation."""
    y = torch.einsum("eck,ekn->ecn", x.float(), w.float())
    return y.to(x.dtype)


def mamba2_ssd_ref(x, dt, A, Bm, Cm):
    """Per-time-step SSM recurrence (sequential oracle; no chunking).

    h_t = exp(dt_t A) h_{t-1} + dt_t * B_t (x) x_t ;  y_t = C_t . h_t
    x (B,S,nh,hd); dt (B,S,nh); A (nh,); Bm/Cm (B,S,G,ds).
    Returns (y (B,S,nh,hd) in x's dtype, h_final (B,nh,hd,ds) f32).
    """
    B, S, nh, hd = x.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    hpg = nh // G
    h = torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        bt = Bm[:, t].repeat_interleave(hpg, dim=1).float()   # (B,nh,ds)
        ct = Cm[:, t].repeat_interleave(hpg, dim=1).float()
        dtt = dt[:, t].float()                                # (B,nh)
        da = torch.exp(dtt * A.float())
        h = da[..., None, None] * h + torch.einsum(
            "bhp,bhs->bhps", dtt[..., None] * x[:, t].float(), bt)
        ys.append(torch.einsum("bhs,bhps->bhp", ct, h))
    return torch.stack(ys, dim=1).to(x.dtype), h
