"""Contiguous-cache flash-decode: the plain PyTorch version of the CUDA
kernel against the reference's Pallas kernel (run in interpret mode on
the CPU) and against the plain oracle, plus the wrapper's contracts.

Cases cover a scalar ``kv_len`` and per-request (B,) lengths (a partial
tile, exactly one tile, one tile plus a row, a single row), group sizes
G in {1, 2, 7, 16} (qwen2-7b at full width has G = 28 / 4 = 7,
qwen3-moe 64 / 4 = 16), a ragged cache length that the reference pads
onto its 128-row tiles, and cache rows past ``kv_len`` filled with
poison.  The plain version runs at the reference's pinned ``block_kv``
of 128, and walks the cache in splits: the kernel's own
(``kernel_split_rows``) or 64 or 128 rows, each split from m = -inf and
the splits combined after, which sums in another order than one walk
and is held to the same tolerances; lengths at the splits' edges too.
It keeps p and each tile's PV product in f32, as the kernel does, where
the reference rounds both to V's dtype; the paged plain version is this
walk over the request's gathered pages.

Tolerances: float32 atol 1e-5 (summation order); bfloat16 atol 1e-2
plus rtol 2**-7, one bf16 ulp at any magnitude (the reference's
roundings of p and PV, each within half an ulp of what it rounds, and
the two outputs' own rounding).  The CUDA kernel is held to
the plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels.ref import decode_attention_ref as jax_ref
from repro_torch.kernels import (decode_attention, decode_attention_plain,
                                 launch_counts, paged_decode_attention_plain)
from repro_torch.kernels.decode_attention import TILE, kernel_split_rows
from repro_torch.kernels.ref import decode_attention_ref

ATOL = {"float32": 1e-5, "bfloat16": 1e-2}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
BLOCK = 128
POISON = 1e4       # finite: the Pallas kernel multiplies masked p = 0 by V


def _case(G, T, *, B=4, KV=2, hd=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, G * KV, hd)).astype(np.float32),
            rng.standard_normal((B, T, KV, hd)).astype(np.float32),
            rng.standard_normal((B, T, KV, hd)).astype(np.float32))


def _poison(k, v, lens):
    k, v = k.copy(), v.copy()
    for b, n in enumerate(np.broadcast_to(lens, (k.shape[0],))):
        k[b, n:], v[b, n:] = POISON, -POISON
    return k, v


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs]


def _lens(kv_len):
    return torch.from_numpy(kv_len) if isinstance(kv_len, np.ndarray) \
        else kv_len


@pytest.mark.parametrize("dtype", list(ATOL))
@pytest.mark.parametrize("G,T,kv_len", [
    (1, 256, np.array([133, 128, 129, 1], np.int32)),
    (2, 200, 150),
    (7, 300, np.array([300, 77, 256, 12], np.int32)),
], ids=["g1_per_request", "g2_scalar_ragged_t", "g7_per_request"])
def test_plain_matches_pallas_kernel(G, T, kv_len, dtype):
    q, k, v = _case(G, T, seed=G)
    k, v = _poison(k, v, kv_len)
    ref = ops.decode_attention(
        *(jnp.asarray(a, JAX_DT[dtype]) for a in (q, k, v)),
        jnp.asarray(kv_len, jnp.int32), block_kv=BLOCK, pad=True,
        interpret=True)
    got = decode_attention_plain(*_torch((q, k, v), dtype), _lens(kv_len),
                                 block_kv=BLOCK)
    assert got.dtype == TORCH_DT[dtype] and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=RTOL[dtype], atol=ATOL[dtype])


CASES = {
    "g1_per_request": (1, 256, np.array([133, 128, 129, 1], np.int32)),
    "g2_scalar_ragged_t": (2, 200, 150),
    "g7_per_request": (7, 300, np.array([300, 77, 256, 12], np.int32)),
    "g16_per_request_hd128": (16, 200, np.array([200, 1, 129, 64], np.int32)),
}


def _pallas(q, k, v, kv_len, dtype):
    return np.asarray(ops.decode_attention(
        *(jnp.asarray(a, JAX_DT[dtype]) for a in (q, k, v)),
        jnp.asarray(kv_len, jnp.int32), block_kv=BLOCK, pad=True,
        interpret=True), np.float32)


@pytest.mark.parametrize("split_rows", [64, 128, None],
                         ids=["split64", "split128", "kernel_split"])
@pytest.mark.parametrize("dtype", list(ATOL))
@pytest.mark.parametrize("name", list(CASES))
def test_split_plain_matches_pallas_kernel(name, dtype, split_rows):
    """The plain version walking the cache in splits (64 or 128 rows, or
    the kernel's own) and combining them, against the Pallas kernel's
    single walk, at the file's tolerances."""
    G, T, kv_len = CASES[name]
    hd = 128 if G == 16 else 32
    q, k, v = _case(G, T, hd=hd, seed=G + 20)
    k, v = _poison(k, v, kv_len)
    got = decode_attention_plain(*_torch((q, k, v), dtype), _lens(kv_len),
                                 block_kv=BLOCK, split_rows=split_rows)
    np.testing.assert_allclose(got.float().numpy(),
                               _pallas(q, k, v, kv_len, dtype),
                               rtol=RTOL[dtype], atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", list(ATOL))
@pytest.mark.parametrize("split_rows", [64, None], ids=["split64",
                                                        "kernel_split"])
def test_split_edges_match_pallas_kernel(split_rows, dtype):
    """Lengths 1, R, R + 1 and T at the split size R, at the kernel's
    64-row tile (and a ragged T), against the Pallas kernel."""
    B, KV, T = 4, 2, 300
    R = kernel_split_rows(T, B * KV) if split_rows is None else split_rows
    assert R < T
    lens = np.array([1, R, R + 1, T], np.int32)
    q, k, v = _case(7, T, B=B, KV=KV, seed=R)
    k, v = _poison(k, v, lens)
    got = decode_attention_plain(*_torch((q, k, v), dtype),
                                 torch.from_numpy(lens), split_rows=R)
    np.testing.assert_allclose(got.float().numpy(),
                               _pallas(q, k, v, lens, dtype),
                               rtol=RTOL[dtype], atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", list(ATOL))
def test_one_split_is_one_walk(dtype):
    """With split_rows >= T the combine over one split changes nothing:
    every split size from T up gives the same bits."""
    lens = np.array([300, 1, 64, 129], np.int32)
    q, k, v = _torch(_case(7, 300, seed=11), dtype)
    one = decode_attention_plain(q, k, v, torch.from_numpy(lens),
                                 split_rows=300)
    for rows in (320, 1024):
        np.testing.assert_array_equal(
            decode_attention_plain(q, k, v, torch.from_numpy(lens),
                                   split_rows=rows).float().numpy(),
            one.float().numpy())


@pytest.mark.parametrize("T,batch_kv,want", [
    (2048, 32, 256),     # qwen2-7b at B = 8: 8 splits, 256 blocks
    (2048, 16, 128),     # B = 4
    (2048, 4, 128),      # B = 1: at least two tiles a split
    (64, 4, 128),        # a split may outrun the cache
    (32768, 4, 512),
])
def test_kernel_split_rows(T, batch_kv, want):
    R = kernel_split_rows(T, batch_kv)
    assert R == want and R % TILE == 0 and R >= 2 * TILE


def _paged_loop_before_split(q, k_pool, v_pool, block_tables, kv_len):
    """paged_decode_attention_plain as it was before its loop became a
    helper shared with the split contiguous version: one walk of the
    request's pages, the page being the tile, with the reference's
    roundings (scores (q * scale) . k, p and each page's PV product
    rounded to V's dtype)."""
    B, H, hd = q.shape
    page, KV = k_pool.shape[1], k_pool.shape[2]
    G = H // KV
    neg = -0.7 * torch.finfo(torch.float32).max
    lens = kv_len.long()
    tables = block_tables.long()
    qf = q.reshape(B, KV, G, hd).float() * (1.0 / np.sqrt(hd))
    m = torch.full((B, KV, G, 1), neg, dtype=torch.float32)
    l = torch.zeros((B, KV, G, 1), dtype=torch.float32)
    acc = torch.zeros((B, KV, G, hd), dtype=torch.float32)
    n_pages = int((lens.max().clamp(min=0) + page - 1) // page)
    cols = torch.arange(page)
    for j in range(n_pages):
        k = k_pool[tables[:, j]].float()
        valid = (j * page + cols)[None, :] < lens[:, None]
        v = torch.where(valid[:, :, None, None], v_pool[tables[:, j]],
                        torch.zeros((), dtype=v_pool.dtype))
        s = torch.einsum("bkgd,btkd->bkgt", qf, k)
        s = torch.where(valid[:, None, None, :], s, neg)
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


@pytest.mark.parametrize("dtype", list(ATOL))
def test_paged_plain_unchanged_by_the_shared_loop(dtype):
    """The paged plain version is the contiguous one's split walk over
    the request's gathered pages, bit for bit, and lies within the
    file's tolerances of its loop from before the split (which kept the
    reference's roundings, where both plain versions now keep p and PV
    in f32 as the kernels do)."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((4, 14, 32)).astype(np.float32)
    kp = rng.standard_normal((9, 16, 2, 32)).astype(np.float32)
    vp = rng.standard_normal((9, 16, 2, 32)).astype(np.float32)
    kp[0], vp[0] = POISON, -POISON
    tables = torch.tensor([[1, 2, 3], [4, 0, 0], [6, 5, 0], [0, 0, 0]],
                          dtype=torch.int32)
    lens = torch.tensor([37, 16, 17, 1], dtype=torch.int32)
    args = _torch((q, kp, vp), dtype) + [tables, lens]
    got = paged_decode_attention_plain(*args).float().numpy()
    k, v = (t[tables.long()].reshape(4, 48, 2, 32) for t in args[1:3])
    np.testing.assert_array_equal(
        got, decode_attention_plain(args[0], k, v, lens).float().numpy())
    np.testing.assert_allclose(
        got, _paged_loop_before_split(*args).float().numpy(),
        rtol=RTOL[dtype], atol=ATOL[dtype])


@pytest.mark.parametrize("kv_len", [1, 64, 65, 100, 500,
                                    np.array([3, 100, 64, 41], np.int32)])
def test_plain_matches_oracles(kv_len):
    """At the kernel's own tile, against the port's full-softmax oracle
    and the reference's; lengths past T attend the whole cache."""
    q, k, v = _case(7, 100, seed=3)
    want = decode_attention_ref(*_torch((q, k, v), "float32"),
                                _lens(np.minimum(kv_len, 100)))
    jwant = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(np.minimum(kv_len, 100), jnp.int32))
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), rtol=0,
                               atol=1e-5)
    got = decode_attention(*_torch((q, k, v), "float32"), _lens(kv_len))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_stale_rows_never_leak():
    """Rows at or past kv_len, even non-finite ones, do not reach the
    output."""
    lens = np.array([5, 64, 65, 1], np.int32)
    q, k, v = _torch(_case(2, 128, seed=4), "float32")
    clean = decode_attention(q, k, v, torch.from_numpy(lens))
    for b, n in enumerate(lens):
        k[b, n:], v[b, n:] = float("nan"), float("inf")
    dirty = decode_attention(q, k, v, torch.from_numpy(lens))
    assert torch.isfinite(dirty).all()
    np.testing.assert_array_equal(dirty.numpy(), clean.numpy())


def test_wrapper_runs_plain_on_cpu_without_counting():
    before = launch_counts()["decode_attention"]
    q, k, v = _torch(_case(7, 96, seed=5), "bfloat16")
    out = decode_attention(q, k, v, 50)
    np.testing.assert_array_equal(
        out.float().numpy(),
        decode_attention_plain(q, k, v, 50).float().numpy())
    assert launch_counts()["decode_attention"] == before


@pytest.mark.parametrize("bad,match", [
    (lambda a: [t[..., :16] for t in a[:3]] + a[3:], "head dim"),
    (lambda a: [a[0].float()] + a[1:], "share one of"),
    (lambda a: [a[0][:, :3]] + a[1:], "does not group"),
    (lambda a: a[:3] + [a[3][:2]], r"\(4,\) int32"),
    (lambda a: a[:3] + [a[3].long()], "int32"),
    (lambda a: [torch.cat([a[0], a[0]], -1)[..., :32]] + a[1:],
     "contiguous"),
])
def test_wrapper_validates(bad, match):
    args = _torch(_case(2, 64, seed=6), "bfloat16") + [
        torch.tensor([1, 2, 3, 4], dtype=torch.int32)]
    with pytest.raises(ValueError, match=match):
        decode_attention(*bad(args))
