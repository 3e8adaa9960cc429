"""Contiguous-cache flash-decode: the plain PyTorch version of the CUDA
kernel against the reference's Pallas kernel (run in interpret mode on
the CPU) and against the plain oracle, plus the wrapper's contracts.

Cases cover a scalar ``kv_len`` and per-request (B,) lengths (a partial
tile, exactly one tile, one tile plus a row, a single row), group sizes
G in {1, 2, 7} (qwen2-7b at full width has G = 28 / 4 = 7), a ragged
cache length that the reference pads onto its 128-row tiles, and cache
rows past ``kv_len`` filled with poison.  The plain version runs at the
reference's pinned ``block_kv`` of 128.

Tolerances: float32 atol 1e-5 (summation order); bfloat16 atol 1e-2
plus rtol 2**-7, one bf16 ulp at any magnitude (the two round at the
same points but sum in different orders).  The CUDA kernel is held to
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
                                 launch_counts)
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
