"""Flash attention: the plain PyTorch version of the CUDA kernel against
the reference's Pallas kernel (run in interpret mode on the CPU) and
against the plain oracle, plus the wrapper's contracts.

Cases cover causal and non-causal attention, ragged S and T (the
reference pads them onto its 128-row tiles through
``repro.kernels.ops.flash_attention(pad=True)``; the port masks them
inside its loop), ``kv_len < T``, and group sizes G in {1, 2, 4, 16}
(jamba's G = 4 and qwen3-moe's G = 16 at head dim 128).  The plain
version runs at the reference's pinned ``block_kv`` of 128, so the two
walk the same tiles; it forms its scores as ``(q . k) * scale``, the
kernel's order, where the reference scales q first, which differs by
f32 rounding only, and it keeps p and each tile's PV product in f32,
where the reference rounds both to V's dtype.

Tolerances: float32 atol 1e-4 (summation order).  bfloat16 atol 1e-2
plus rtol 2**-7, which is one bf16 ulp at any magnitude: the
reference's roundings of p and of each tile's PV product (each within
half an ulp of what it rounds) and the two outputs' own rounding may
put an output one ulp apart, and at |x| >= 2 one ulp (2**-6) is more
than 1e-2.  The CUDA kernel is held to the plain version on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels.ref import flash_attention_ref as jax_ref
from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                 launch_counts)
from repro_torch.kernels.ref import flash_attention_ref

ATOL = {"float32": 1e-4, "bfloat16": 1e-2}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
BLOCK = 128

# (B, S, T, H, KV, hd, causal, kv_len)
CASES = {
    "causal_ragged_g2": (2, 200, 200, 4, 2, 32, True, None),
    "causal_kv_len_g2": (1, 200, 200, 4, 2, 32, True, 150),
    "noncausal_s_ne_t_g1": (1, 96, 256, 2, 2, 64, False, None),
    "noncausal_kv_len_g1": (2, 130, 250, 4, 4, 32, False, 177),
    "causal_g4_hd64": (1, 130, 130, 8, 2, 64, True, None),      # jamba's G
    "causal_kv_len_g16_hd128": (1, 200, 200, 16, 1, 128, True, 150),
}


def _case(B, S, T, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, KV, hd)).astype(np.float32),
            rng.standard_normal((B, T, KV, hd)).astype(np.float32))


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs]


@pytest.mark.parametrize("dtype", list(ATOL))
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_kernel(name, dtype):
    B, S, T, H, KV, hd, causal, kv_len = CASES[name]
    arrs = _case(B, S, T, H, KV, hd, seed=len(name))
    ref = ops.flash_attention(
        *(jnp.asarray(a, JAX_DT[dtype]) for a in arrs), causal=causal,
        kv_len=kv_len, block_q=BLOCK, block_kv=BLOCK, pad=True,
        interpret=True)
    got = flash_attention_plain(*_torch(arrs, dtype), causal=causal,
                                kv_len=kv_len, block_kv=BLOCK)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=RTOL[dtype], atol=ATOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_oracles(causal):
    """At the kernel's own tile and at others, against the port's
    full-softmax oracle and the reference's."""
    arrs = _case(2, 150, 150, 6, 2, 64, seed=7)
    q, k, v = _torch(arrs, "float32")
    want = flash_attention_ref(q, k, v, causal=causal)
    jwant = jax_ref(*(jnp.asarray(a) for a in arrs), causal=causal)
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), rtol=0,
                               atol=1e-5)
    for block in (16, 64, 150, 256):
        got = flash_attention_plain(q, k, v, causal=causal, block_kv=block)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)


def test_rows_past_kv_len_never_leak():
    """Key/value rows at or past kv_len, even non-finite ones, do not
    reach the output."""
    q, k, v = _torch(_case(1, 64, 128, 4, 2, 32, seed=8), "float32")
    clean = flash_attention(q, k, v, causal=False, kv_len=70)
    k[:, 70:], v[:, 70:] = float("nan"), float("inf")
    dirty = flash_attention(q, k, v, causal=False, kv_len=70)
    assert torch.isfinite(dirty).all()
    np.testing.assert_array_equal(dirty.numpy(), clean.numpy())


def test_wrapper_runs_plain_on_cpu_without_counting():
    before = launch_counts()["flash_attention"]
    q, k, v = _torch(_case(1, 70, 70, 4, 2, 32, seed=9), "bfloat16")
    out = flash_attention(q, k, v)
    np.testing.assert_array_equal(out.float().numpy(),
                                  flash_attention_plain(q, k, v)
                                  .float().numpy())
    assert launch_counts()["flash_attention"] == before


@pytest.mark.parametrize("bad,match", [
    (lambda a: [t[..., :16] for t in a], "head dim"),
    (lambda a: [a[0].float()] + a[1:], "share one of"),
    (lambda a: [a[0][:, :, :3]] + a[1:], "does not group"),
    (lambda a: [a[0], a[1], a[2][:, :5]], "of one shape"),
    (lambda a: [torch.cat([a[0], a[0]], -1)[..., :32]] + a[1:],
     "contiguous"),
    (lambda a: [a[0][:, :0]] + a[1:], "empty operand"),
])
def test_wrapper_validates(bad, match):
    args = _torch(_case(1, 40, 40, 4, 2, 32, seed=10), "bfloat16")
    with pytest.raises(ValueError, match=match):
        flash_attention(*bad(args))
