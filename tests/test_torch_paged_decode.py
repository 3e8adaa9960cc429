"""Paged flash-decode: the plain PyTorch version of the CUDA kernel against
the reference's Pallas kernel (run in interpret mode on the CPU) and
against the plain oracle, plus the wrapper's contracts.

Cases cover group sizes G in {1, 2, 7, 16} (qwen2-7b at full width has
G = 28 / 4 = 7, qwen3-moe 64 / 4 = 16), ragged per-request lengths,
partial last pages, table tails pointing at null block 0 filled with
poison, and an idle slot at kv_len 1 against the null block.  The
reference's Pallas kernel needs 128-row pages; other page sizes are held
to the oracle only.  The plain version walks the gathered pages in the
kernel's splits (``kernel_split_rows`` of the table capacity NB * page),
each in 64-row tiles, and combines them; with ``split_rows`` forced to
64 or 192 rows the splits cross page boundaries (pages of 16 and 32) or
cut a page (128).

Tolerances: float32 atol 1e-5 (summation order); bfloat16 atol 1e-2,
about one bf16 ulp at the outputs' magnitude (< 2 here).  The plain
version, as the kernel, forms scores as (q . k) * scale and keeps p and
each tile's PV product in f32, rounding only the output, where the
Pallas kernel forms (q * scale) . k and rounds p and each page's PV
product to bf16; each of those roundings is within half an ulp of what
it rounds, and both sum in different orders.  The CUDA kernel is held
to the plain version on the card by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import \
    paged_decode_attention as pallas_paged_decode
from repro.kernels.ref import paged_decode_attention_ref as jax_ref
from repro_torch.kernels import (launch_counts, paged_decode_attention,
                                 paged_decode_attention_plain)
from repro_torch.kernels.ref import paged_decode_attention_ref

ATOL = {"float32": 1e-5, "bfloat16": 1e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _case(G, page, *, KV=2, hd=32, seed=0):
    """Four requests: two pages and a partial third, exactly one page,
    one page plus a row, and an idle slot (kv_len 1 on the null block).
    Unused table slots hold null block 0, which carries poison."""
    rng = np.random.default_rng(seed)
    B, P, NB = 4, 8, 3
    q = rng.standard_normal((B, G * KV, hd)).astype(np.float32)
    kp = rng.standard_normal((P, page, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((P, page, KV, hd)).astype(np.float32)
    kp[0], vp[0] = 40.0, -40.0
    tables = np.array([[1, 2, 3], [4, 0, 0], [6, 5, 0], [0, 0, 0]], np.int32)
    lens = np.array([2 * page + 5, page, page + 1, 1], np.int32)
    return q, kp, vp, tables, lens


def _torch(arrs, dtype):
    q, kp, vp, tables, lens = arrs
    return ([torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (q, kp, vp)]
            + [torch.from_numpy(tables), torch.from_numpy(lens)])


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", list(ATOL))
@pytest.mark.parametrize("G", [1, 2, 7, 16])
def test_plain_matches_pallas_kernel(G, dtype):
    arrs = _case(G, 128, seed=G)
    q, kp, vp, tables, lens = arrs
    ref = pallas_paged_decode(
        *(jnp.asarray(a, JAX_DT[dtype]) for a in (q, kp, vp)),
        jnp.asarray(tables), jnp.asarray(lens), interpret=True)
    got = paged_decode_attention_plain(*_torch(arrs, dtype))
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                               rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", list(ATOL))
@pytest.mark.parametrize("G,page", [(1, 16), (2, 64), (7, 32), (7, 128)])
def test_plain_matches_oracle(G, page, dtype):
    arrs = _case(G, page, seed=10 + G)
    got = paged_decode_attention_plain(*_torch(arrs, dtype))
    want = paged_decode_attention_ref(*_torch(arrs, dtype))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL[dtype])
    # the reference's own oracle agrees too
    q, kp, vp, tables, lens = arrs
    jref = jax_ref(*(jnp.asarray(a, JAX_DT[dtype]) for a in (q, kp, vp)),
                   jnp.asarray(tables), jnp.asarray(lens))
    np.testing.assert_allclose(_np(want), np.asarray(jref, np.float32),
                               rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("split_rows", [64, 192])
@pytest.mark.parametrize("dtype", list(ATOL))
@pytest.mark.parametrize("G,page", [(1, 16), (7, 32), (16, 128)])
def test_split_plain_matches_oracle(G, page, dtype, split_rows):
    """Splits smaller than the table: at pages of 16 and 32 rows every
    split spans several pages, at 128 a split of 64 rows is half a page
    and one of 192 crosses a page boundary in its middle."""
    arrs = _case(G, page, seed=30 + G)
    got = paged_decode_attention_plain(*_torch(arrs, dtype),
                                       split_rows=split_rows)
    want = paged_decode_attention_ref(*_torch(arrs, dtype))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", list(ATOL))
def test_one_split_is_the_unsplit_walk(dtype):
    """With split_rows at least the table's NB * page rows the combine
    over one split changes nothing: every such split size gives the same
    bits, and they lie within the tolerance of the kernel's split."""
    args = _torch(_case(7, 32, seed=8), dtype)
    T = args[3].shape[1] * args[1].shape[1]
    one = paged_decode_attention_plain(*args, split_rows=T)
    for rows in (T + 64, 10 * T):
        np.testing.assert_array_equal(
            _np(paged_decode_attention_plain(*args, split_rows=rows)),
            _np(one))
    np.testing.assert_allclose(_np(paged_decode_attention_plain(
        *args, split_rows=64)), _np(one), rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("split_rows", [64, None], ids=["split64",
                                                        "kernel_split"])
def test_poison_never_leaks_across_splits(split_rows):
    """Non-finite rows on the null block and past kv_len in the last page
    reach no split: every split past a request's length contributes
    nothing, and the live ones mask the tail."""
    arrs = _case(7, 16, seed=9)
    q, kp, vp, tables, lens = arrs
    clean = paged_decode_attention_plain(*_torch(arrs, "float32"),
                                         split_rows=split_rows)
    kp, vp = kp.copy(), vp.copy()
    kp[3, 5:], vp[3, 5:] = np.nan, np.inf     # past request 0's 2*16+5
    kp[0, 1:], vp[0, 1:] = np.inf, np.nan     # null block past kv_len 1
    kp[5, 1:], vp[5, 1:] = np.nan, np.nan     # past request 2's 16+1
    dirty = paged_decode_attention_plain(
        *_torch((q, kp, vp, tables, lens), "float32"), split_rows=split_rows)
    assert torch.isfinite(dirty).all()
    np.testing.assert_array_equal(_np(dirty), _np(clean))


def test_poison_past_kv_len_never_leaks():
    """Rows past kv_len, even non-finite ones, do not reach the output:
    the last page's tail and every table slot past the prefix."""
    arrs = _case(2, 64, seed=3)
    q, kp, vp, tables, lens = arrs
    clean = paged_decode_attention_plain(*_torch(arrs, "float32"))
    kp, vp = kp.copy(), vp.copy()
    kp[3, 5:], vp[3, 5:] = np.nan, np.inf     # past request 0's 2*64+5
    kp[0, 1:], vp[0, 1:] = np.inf, np.nan     # null block past kv_len 1
    dirty = paged_decode_attention_plain(
        *_torch((q, kp, vp, tables, lens), "float32"))
    assert torch.isfinite(dirty).all()
    np.testing.assert_array_equal(_np(dirty), _np(clean))


def test_wrapper_runs_plain_on_cpu_without_counting():
    before = launch_counts()["paged_decode_attention"]
    args = _torch(_case(7, 32, seed=4), "bfloat16")
    out = paged_decode_attention(*args)
    np.testing.assert_array_equal(_np(out),
                                  _np(paged_decode_attention_plain(*args)))
    assert launch_counts()["paged_decode_attention"] == before


@pytest.mark.parametrize("bad,match", [
    (lambda a: [t[..., :16] for t in a[:3]] + a[3:], "head dim"),
    (lambda a: a[:3] + [a[3].long(), a[4]], "int32"),
    (lambda a: [a[0].float()] + a[1:], "share one of"),
    (lambda a: a[:4] + [a[4][:2]], r"kv_len \(B,\)"),
    (lambda a: [a[0][:, :3]] + a[1:], "do not group"),
    (lambda a: [a[0], a[1][:, :24].contiguous(), a[2][:, :24].contiguous()]
     + a[3:], "multiple of 16"),
])
def test_wrapper_validates(bad, match):
    args = _torch(_case(2, 32, seed=5), "bfloat16")
    with pytest.raises(ValueError, match=match):
        paged_decode_attention(*bad(args))
