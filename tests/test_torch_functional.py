"""The port's functional MFMA oracle against the reference's.

``random_operands`` must give the reference's values for every one of
the 17 instructions (both draw from ``np.random.RandomState(seed)``), and
``mfma_apply`` the reference's result: exactly for i8 (int32
accumulation) and fp64 (the reference run with jax's 64-bit types on,
without which it truncates fp64 to f32), to 1e-6 relative for f32
outputs (one product of up to 32 terms summed in another order by
XLA:CPU and by PyTorch).  Also the numpy checks of
``tests/test_functional.py`` and the shape errors.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import functional as ref_fn
from repro.core import isa as ref_isa
from repro_torch.core import isa
from repro_torch.core.functional import (mfma_apply, operand_dtypes,
                                         random_operands)

NAMES = list(ref_isa.MFMA_REGISTRY)


def _np(x):
    """A tensor or jax array as float64 (or int64) numpy, fp8 included."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.int32 or x.dtype == torch.int8:
            return x.numpy().astype(np.int64)
        return x.to(torch.float64).numpy()
    x = np.asarray(x)
    return x.astype(np.int64 if x.dtype.kind == "i" else np.float64)


@pytest.mark.parametrize("name", NAMES)
def test_random_operands_equal_reference(name):
    with jax.enable_x64(True):
        want = ref_fn.random_operands(name, seed=3)
    got = random_operands(name, seed=3, device="cpu")
    in_dt, out_dt = operand_dtypes(name)
    assert [t.dtype for t in got] == [in_dt, in_dt, out_dt]
    assert [str(t.dtype).split(".")[-1] for t in got] == \
        [str(w.dtype) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("name", NAMES)
def test_mfma_apply_equals_reference(name):
    instr = isa.lookup(name)
    with jax.enable_x64(True):
        a, b, c = ref_fn.random_operands(name, seed=4)
        want = _np(ref_fn.mfma_apply(name, a, b, c))
    got = mfma_apply(name, *random_operands(name, seed=4, device="cpu"))
    assert got.dtype == operand_dtypes(name)[1]
    assert tuple(got.shape) == instr.d_shape
    if instr.out_dtype in ("i32", "fp64"):
        np.testing.assert_array_equal(_np(got), want)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["fp32_16x16x16fp16", "fp32_4x4x1fp32",
                                  "fp64_4x4x4fp64", "i32_16x16x16i8",
                                  "fp32_16x16x4fp32"])
def test_mfma_matches_numpy(name):
    """The reference's own numpy check, on numpy operands placed on the
    CPU (as its composition test feeds the oracle)."""
    a, b, c = (_np(t) for t in random_operands(name, seed=3, device="cpu"))
    d = mfma_apply(name, a, b, c, device="cpu")
    instr = isa.lookup(name)
    want = c + np.einsum("bmk,bkn->bmn", a, b)
    assert tuple(d.shape) == instr.d_shape
    tol = 1e-2 if instr.in_dtype in ("fp16", "bf16") else 1e-6
    np.testing.assert_allclose(_np(d), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["i32_16x16x16i8", "i32_16x16x32i8",
                                  "i32_32x32x16i8"])
def test_i8_exact(name):
    """Integer MFMA is exact, at the full int8 range too (the float64
    product is exact far beyond these magnitudes)."""
    rng = np.random.RandomState(0)
    instr = isa.lookup(name)
    a = rng.randint(-128, 128, size=instr.a_shape).astype(np.int8)
    b = rng.randint(-128, 128, size=instr.b_shape).astype(np.int8)
    c = rng.randint(-2 ** 30, 2 ** 30, size=instr.d_shape).astype(np.int32)
    d = mfma_apply(name, a, b, c, device="cpu")
    want = c.astype(np.int64) + np.einsum(
        "bmk,bkn->bmn", a.astype(np.int64), b.astype(np.int64))
    assert d.dtype == torch.int32
    np.testing.assert_array_equal(d.numpy().astype(np.int64), want)


def test_operand_dtypes():
    assert operand_dtypes("fp32_16x16x16fp16") == (torch.float16,
                                                    torch.float32)
    assert operand_dtypes("fp32_16x16x32fp8") == (torch.float8_e4m3fn,
                                                   torch.float32)
    assert operand_dtypes("i32_16x16x16i8") == (torch.int8, torch.int32)
    assert operand_dtypes("fp64_4x4x4fp64") == (torch.float64,
                                                torch.float64)


def test_bad_shapes_raise():
    a, b, c = random_operands("fp32_16x16x4fp32", device="cpu")
    with pytest.raises(ValueError, match=r"a has shape \(1, 16, 8\)"):
        mfma_apply("fp32_16x16x4fp32", torch.zeros(1, 16, 8), b, c)
    with pytest.raises(ValueError, match=r"b has shape \(1, 4, 8\)"):
        mfma_apply("fp32_16x16x4fp32", a, b[:, :, :8], c)
    with pytest.raises(ValueError, match=r"takes \(1, 16, 16\)"):
        mfma_apply("fp32_16x16x4fp32", a, b, c[0])
    with pytest.raises(isa.UnsupportedInstructionError):
        mfma_apply("fp32_1x1x1fp32", a, b, c)


def test_numpy_operands_default_to_cuda(monkeypatch):
    """Numpy operands go to ``device`` ("cuda" by default), which raises
    without a GPU instead of computing on the CPU."""
    a, b, c = (t.numpy() for t in random_operands("fp32_16x16x4fp32",
                                                  device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mfma_apply("fp32_16x16x4fp32", a, b, c)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_operands("fp32_16x16x4fp32")
