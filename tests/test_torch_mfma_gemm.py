"""The MFMA GEMM, D = C + A @ B: the plain PyTorch version of the CUDA
kernel against the reference's Pallas kernel (run in interpret mode on
the CPU, through ``repro.kernels.ops.mfma_gemm``), against micro-op
compositions of the port's functional oracle, and the wrapper's
contracts.

Tolerances, both with f32 C: f32 operands atol 1e-4 plus rtol 1e-5 (one
K-split order against another: the plain version and the Pallas kernel
both add 128-deep f32 products to the f32 accumulator, each product
summed in its own order, outputs up to ~140); bf16 operands the same
(their products are exact in f32, so only the order differs).  bf16 C:
atol 1e-2 plus rtol 2**-7, one bf16 ulp at any magnitude (both round one
f32 sum once).  Micro-op compositions: 1e-4, the reference's own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels.ref import mfma_gemm_ref as jax_ref
from repro_torch.core.functional import mfma_apply
from repro_torch.kernels import launch_counts, mfma_gemm, mfma_gemm_plain
from repro_torch.kernels.mfma_gemm import BLOCK_K, decode_splits
from repro_torch.kernels.ref import mfma_gemm_ref

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
F32_TOL = dict(rtol=1e-5, atol=1e-4)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-2)


def _case(m, n, k, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            rng.randn(k, n).astype(np.float32),
            rng.randn(m, n).astype(np.float32))


def _torch(arrs, dtype, c_dtype=torch.float32):
    a, b, c = arrs
    return (torch.from_numpy(a).to(TORCH_DT[dtype]),
            torch.from_numpy(b).to(TORCH_DT[dtype]),
            torch.from_numpy(c).to(c_dtype))


def _jax(arrs, dtype, c_dtype=jnp.float32):
    a, b, c = arrs
    return (jnp.asarray(a, JAX_DT[dtype]), jnp.asarray(b, JAX_DT[dtype]),
            jnp.asarray(c, c_dtype))


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (256, 128, 512),
                                   (384, 256, 256), (128, 512, 1024)])
@pytest.mark.parametrize("dtype", list(TORCH_DT))
def test_plain_matches_pallas_kernel_sweep(m, n, k, dtype):
    """The reference's sweep (``tests/test_kernels_gemm.py``) at its
    128-deep K blocks on both sides."""
    arrs = _case(m, n, k, seed=m + n + k)
    want = ops.mfma_gemm(*_jax(arrs, dtype), block_m=128, block_n=128,
                         block_k=128, interpret=True)
    got = mfma_gemm_plain(*_torch(arrs, dtype), block_k=128)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    _close(got, want)


@pytest.mark.parametrize("m,n,k,pallas_k", [(128, 128, 64, 64),
                                            (128, 256, 384, 128),
                                            (256, 128, 1024, 128)])
@pytest.mark.parametrize("dtype", list(TORCH_DT))
def test_plain_at_kernel_block_k_matches_pallas_kernel(m, n, k, pallas_k,
                                                       dtype):
    """The plain version at the kernels' own 64-deep slices (``BLOCK_K``)
    against the Pallas kernel at its 128-deep blocks (or one 64-deep
    block when K = 64): the K split changes only the summation order."""
    assert BLOCK_K == 64
    arrs = _case(m, n, k, seed=m + 2 * n + k)
    want = ops.mfma_gemm(*_jax(arrs, dtype), block_m=128, block_n=128,
                         block_k=pallas_k, interpret=True)
    got = mfma_gemm_plain(*_torch(arrs, dtype))
    _close(got, want)


def test_plain_matches_pallas_kernel_bf16_c():
    """A bf16 C: the output is C's dtype, rounded once."""
    arrs = _case(128, 256, 384, seed=5)
    want = ops.mfma_gemm(*_jax(arrs, "bfloat16", jnp.bfloat16), block_m=128,
                         block_n=128, block_k=128, interpret=True)
    got = mfma_gemm_plain(*_torch(arrs, "bfloat16", torch.bfloat16),
                          block_k=128)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


def test_is_accumulate():
    """D = C + A@B: C must accumulate, as in the reference's test and
    kernel; with integer-valued operands every sum is exact, so the two
    outputs are exactly 3 apart."""
    a, b, _ = _torch(_case(128, 128, 128, seed=6), "float32")
    c0 = torch.zeros((128, 128))
    np.testing.assert_allclose((mfma_gemm(a, b, c0 + 3.0)
                                - mfma_gemm(a, b, c0)).numpy(),
                               np.full((128, 128), 3.0), rtol=1e-5,
                               atol=1e-5)
    ai, bi = a.round().clamp(-4, 4), b.round().clamp(-4, 4)
    assert bool(((mfma_gemm(ai, bi, c0 + 3.0) - mfma_gemm(ai, bi, c0))
                 == 3.0).all())
    want = ops.mfma_gemm(jnp.asarray(ai.numpy()), jnp.asarray(bi.numpy()),
                         jnp.full((128, 128), 3.0, jnp.float32),
                         interpret=True)
    np.testing.assert_array_equal(mfma_gemm(ai, bi, c0 + 3.0).numpy(),
                                  np.asarray(want))


def _compose(instr, a, b, c, tm, tk):
    """D accumulated over (M/tm x N/tm x K/tk) tiles of one MFMA
    instruction through the port's functional oracle, numpy in and out
    (as the reference's composition test feeds its oracle)."""
    M, K = a.shape
    N = b.shape[1]
    d = c.copy()
    for i in range(M // tm):
        for j in range(N // tm):
            for kk in range(K // tk):
                rows, cols = slice(i * tm, (i + 1) * tm), \
                    slice(j * tm, (j + 1) * tm)
                ks = slice(kk * tk, (kk + 1) * tk)
                blk = mfma_apply(instr, a[None, rows, ks], b[None, ks, cols],
                                 d[None, rows, cols], device="cpu")
                d[rows, cols] = blk[0].numpy()
    return d


def test_matches_mfma_microops():
    """The reference's test: composing fp32_16x16x4fp32 over a
    128 x 128 x 8 GEMM equals the Pallas kernel, and the port's GEMM."""
    a, b, c = _case(128, 128, 8, seed=7)
    d = _compose("fp32_16x16x4fp32", a, b, c, 16, 4)
    want = ops.mfma_gemm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                         block_m=128, block_n=128, block_k=8, interpret=True)
    np.testing.assert_allclose(np.asarray(want), d, rtol=1e-4, atol=1e-4)
    got = mfma_gemm(*(torch.from_numpy(x) for x in (a, b, c)))
    np.testing.assert_allclose(got.numpy(), d, rtol=1e-4, atol=1e-4)


def test_matches_bf16_mfma_microops():
    """fp32_16x16x16bf16 over a 128 x 128 x 32 bf16 GEMM."""
    a, b, c = _case(128, 128, 32, seed=8)
    a = torch.from_numpy(a).bfloat16().float().numpy()   # bf16 values
    b = torch.from_numpy(b).bfloat16().float().numpy()
    d = _compose("fp32_16x16x16bf16", a, b, c, 16, 16)
    got = mfma_gemm(torch.from_numpy(a).bfloat16(),
                    torch.from_numpy(b).bfloat16(), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), d, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,n,k", [(100, 60, 200), (64, 64, 64),
                                   (130, 128, 250)])
def test_ragged_matches_pallas_kernel_padded(m, n, k):
    """Ragged M, N and K need no padding in the port; the reference pads
    them onto its tiles (``pad=True``) and slices, which is exact."""
    arrs = _case(m, n, k, seed=m + k)
    want = ops.mfma_gemm(*_jax(arrs, "float32"), pad=True, interpret=True)
    got = mfma_gemm(*_torch(arrs, "float32"))
    assert tuple(got.shape) == (m, n)
    _close(got, want)


def test_port_accepts_sub128_dims_where_the_reference_raises():
    """A deliberate difference: the reference's MXU tiling rejects
    M = 64 without ``pad=True``; the port's kernel masks any edge."""
    arrs = _case(64, 128, 128, seed=9)
    with pytest.raises(ValueError, match="M=64"):
        ops.mfma_gemm(*_jax(arrs, "float32"))
    got = mfma_gemm(*_torch(arrs, "float32"))
    want = ops.mfma_gemm(*_jax(arrs, "float32"), pad=True, interpret=True)
    _close(got, want)


@pytest.mark.parametrize("c_dtype", [jnp.float32, jnp.bfloat16])
def test_oracle_matches_reference_oracle(c_dtype):
    arrs = _case(40, 72, 90, seed=10)
    torch_c = torch.float32 if c_dtype == jnp.float32 else torch.bfloat16
    want = jax_ref(*_jax(arrs, "bfloat16", c_dtype))
    got = mfma_gemm_ref(*_torch(arrs, "bfloat16", torch_c))
    assert got.dtype == torch_c
    _close(got, want, F32_TOL if c_dtype == jnp.float32 else BF16_TOL)


@pytest.mark.parametrize("block_k", [1, 16, BLOCK_K, 128, 1000])
def test_block_k_invariance(block_k):
    """The K split changes only the summation order: integer-valued
    operands give the same output at any block_k, random ones agree to
    f32 rounding."""
    a, b, c = _torch(_case(48, 40, 200, seed=11), "float32")
    ref = mfma_gemm_ref(a, b, c)
    _close(mfma_gemm_plain(a, b, c, block_k=block_k), ref)
    ai, bi = a.round(), b.round()
    assert torch.equal(mfma_gemm_plain(ai, bi, c.round(), block_k=block_k),
                       mfma_gemm_ref(ai, bi, c.round()))


@pytest.mark.parametrize("M,N,K,want", [
    (8, 18944, 3584, 3),     # qwen2-7b gate/up at decode: 296 column tiles
    (8, 3584, 18944, 8),     # its down projection: 56 tiles, at most 8
    (8, 256, 1032, 4),       # 17 slices: at least 4 slices a split
    (64, 18944, 256, 1),     # 4 slices: no split
    (65, 8, 4096, 1),        # past the decode rows: the wgmma path
    (1, 64 * 6 * 132, 4096, 1),  # six blocks an SM without a split
])
def test_decode_splits(M, N, K, want):
    """The decode path's split over K on a 132-SM card: enough splits of
    the 64-column tiles for six blocks an SM, each split at least four
    64-deep slices, at most eight splits, none past 64 rows."""
    assert decode_splits(M, N, K, 132) == want


def test_wrapper_runs_plain_on_cpu_without_counting():
    before = launch_counts()["mfma_gemm"]
    a, b, c = _torch(_case(20, 24, 40, seed=12), "bfloat16")
    assert torch.equal(mfma_gemm(a, b, c), mfma_gemm_plain(a, b, c))
    assert launch_counts()["mfma_gemm"] == before


@pytest.mark.parametrize("bad,match", [
    (lambda a, b, c: (a, b[1:], c), "incompatible operands"),
    (lambda a, b, c: (a, b, c[:, 1:]), "incompatible operands"),
    (lambda a, b, c: (a[None], b, c), "incompatible operands"),
    (lambda a, b, c: (a[:0], b, c[:0]), "empty operand"),
    (lambda a, b, c: (a.float(), b, c), "share one of"),
    (lambda a, b, c: (a.double(), b.double(), c), "share one of"),
    (lambda a, b, c: (a, b, c.double()), "c must be one of"),
    (lambda a, b, c: (a, b.t().contiguous().t(), c), "contiguous"),
    (lambda a, b, c: (a, b, c.to("meta")), "all operands must be on"),
])
def test_wrapper_validates(bad, match):
    a, b, c = _torch(_case(20, 24, 40, seed=13), "bfloat16")
    with pytest.raises(ValueError, match=match):
        mfma_gemm(*bad(a, b, c))


def test_plain_rejects_a_non_positive_block_k():
    a, b, c = _torch(_case(8, 8, 8, seed=14), "float32")
    with pytest.raises(ValueError, match="block_k"):
        mfma_gemm_plain(a, b, c, block_k=0)
