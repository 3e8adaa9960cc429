"""The MoE grouped GEMM: the plain PyTorch version of the CUDA kernel
against the reference's Pallas kernel (run in interpret mode on the CPU,
through ``repro.kernels.ops.moe_gmm(pad=True)``, which zero-pads ragged
C, K and N onto its tiles and slices the result) and against the plain
oracles, plus the wrapper's contracts.

Cases cover capacity-trimmed C (multiples of 4, not of the 128-row
tile), ragged K and N, and one expert, and the capacities the serving
paths give the kernel, each on another of its row tiles (16, 32, 64 or
128 rows, the smallest that covers C): C = 4 (jamba's B = 1 decode),
32 (qwen3-moe's decode, 8 slots x 4), 44 (ragged) and 160 (a 2000-row
qwen3-moe prefill), at small K and N.

Tolerances: float32 atol 1e-4 plus rtol 1e-5 (summation order over K up
to 200, products of unit normals).  bfloat16 atol 1e-2 plus rtol 2**-7,
which is one bf16 ulp at any magnitude: both accumulate the same exact
products in f32 and round once, but sum in different orders, so an
output may land one ulp apart.  The CUDA kernel is held to the plain
version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels.ref import moe_gmm_ref as jax_ref
from repro_torch.kernels import launch_counts, moe_gmm, moe_gmm_plain
from repro_torch.kernels.ref import moe_gmm_ref

ATOL = {"float32": 1e-4, "bfloat16": 1e-2}
RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# (E, C, K, N)
CASES = {
    "capacity_ragged_k_n": (4, 20, 100, 60),
    "decode_like": (4, 8, 128, 64),
    "one_expert_odd": (1, 44, 37, 129),
    "deep_k": (2, 12, 200, 32),
    "decode_c4": (3, 4, 64, 48),
    "decode_c32": (2, 32, 96, 40),
    "ragged_c44": (2, 44, 40, 72),
    "prefill_c160": (2, 160, 48, 136),
}


def _case(E, C, K, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, C, K)).astype(np.float32),
            rng.standard_normal((E, K, N)).astype(np.float32))


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=RTOL[dtype], atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", list(ATOL))
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_kernel(name, dtype):
    E, C, K, N = CASES[name]
    arrs = _case(E, C, K, N, seed=len(name))
    ref = ops.moe_gmm(*(jnp.asarray(a, JAX_DT[dtype]) for a in arrs),
                      pad=True, interpret=True)
    got = moe_gmm_plain(*_torch(arrs, dtype))
    assert got.dtype == TORCH_DT[dtype] and got.shape == (E, C, N)
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", list(ATOL))
def test_oracle_matches_reference_oracle(dtype):
    arrs = _case(3, 20, 70, 45, seed=3)
    want = jax_ref(*(jnp.asarray(a, JAX_DT[dtype]) for a in arrs))
    got = moe_gmm_ref(*_torch(arrs, dtype))
    assert got.dtype == TORCH_DT[dtype]
    _close(got, want, dtype)
    _close(moe_gmm_plain(*_torch(arrs, dtype)), got.float().numpy(), dtype)


def test_zero_slots_give_zero_rows():
    """Empty capacity slots (zero rows of x) come out exactly zero, as
    the MoE dispatch relies on."""
    x, w = _torch(_case(2, 8, 40, 24, seed=4), "bfloat16")
    x[:, 5:] = 0
    out = moe_gmm(x, w)
    assert bool((out[:, 5:] == 0).all())


def test_wrapper_runs_plain_on_cpu_without_counting():
    before = launch_counts()["moe_gmm"]
    x, w = _torch(_case(2, 12, 40, 24, seed=5), "bfloat16")
    np.testing.assert_array_equal(moe_gmm(x, w).float().numpy(),
                                  moe_gmm_plain(x, w).float().numpy())
    assert launch_counts()["moe_gmm"] == before


@pytest.mark.parametrize("bad,match", [
    (lambda x, w: (x, w[1:]), "matching expert count E"),
    (lambda x, w: (x, w[:, 1:]), "contraction depth K"),
    (lambda x, w: (x[0], w), r"want x \(E, C, K\)"),
    (lambda x, w: (x.float(), w), "share one of"),
    (lambda x, w: (x.transpose(1, 2).contiguous().transpose(1, 2), w),
     "contiguous"),
    (lambda x, w: (x[:, :0], w), "empty operand"),
])
def test_wrapper_validates(bad, match):
    x, w = _torch(_case(2, 12, 40, 24, seed=6), "bfloat16")
    with pytest.raises(ValueError, match=match):
        moe_gmm(*bad(x, w))
