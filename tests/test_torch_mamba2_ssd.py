"""The chunked SSD scan: the plain PyTorch version of the CUDA kernel
against the reference's Pallas kernel (run in interpret mode on the CPU
through ``repro.kernels.ops.mamba2_ssd``, at the same chunk) and against
the sequential oracles of both packages, plus the wrapper's contracts.

Cases are the reference's kernel sweep (``tests/test_kernels_ssd.py``),
two groups of B/C included, and a ragged S = 52, which the reference
pads with dt = 0 identity steps and the port masks: y and the final
state must equal the unpadded oracle's.  The plain version's four
passes (the kernels' structure: scores once per group, chunk states
from zero, the scan over chunks, the outputs) are also swept over S in
(1, 63, 64, 65, 130), one and two groups and every state size, in f32
and bf16, and its carried states are held to the step-by-step
recurrence at every chunk's first row.

Tolerance: float32 atol and rtol 2e-3, the reference's own for its SSD
kernel against the oracle (a chunked scan sums in another order than the
step-by-step recurrence).  bfloat16 (x, B and C rounded to bf16, dt and
A f32): y within 2e-2 + 2**-7 |y| of the Pallas kernel, one or two bf16
ulps of y, which both round once from f32 sums taken in different
orders; the f32 state within 2e-3.  The CUDA kernel is held to the
plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels.plan import plan_for
from repro.kernels.ref import mamba2_ssd_ref as jax_ref
from repro_torch.kernels import launch_counts, mamba2_ssd, mamba2_ssd_plain
from repro_torch.kernels.mamba2_ssd import CHUNK
from repro_torch.kernels.ref import mamba2_ssd_ref

# the module (the package re-exports its function under the same name)
ssd_mod = importlib.import_module("repro_torch.kernels.mamba2_ssd")

TOL = 2e-3

# (B, S, nh, hd, G, ds, chunk); chunk None = the reference planner's
CASES = {
    "one_group": (1, 64, 2, 16, 1, 16, 16),
    "two_groups": (2, 128, 4, 32, 2, 16, 32),
    "wide_state": (1, 256, 8, 16, 1, 32, 64),
    "ragged_52": (2, 52, 2, 16, 1, 16, None),
    "ragged_52_two_groups": (2, 52, 4, 16, 2, 16, None),
}


def _inputs(B, S, nh, hd, G, ds, seed=11):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, nh, hd).astype(np.float32) * 0.5,
            (np.abs(rng.randn(B, S, nh)) * 0.4 + 0.05).astype(np.float32),
            (-np.abs(rng.randn(nh)) - 0.1).astype(np.float32),
            rng.randn(B, S, G, ds).astype(np.float32) * 0.5,
            rng.randn(B, S, G, ds).astype(np.float32) * 0.5)


def _pallas(arrs, chunk, dtype=jnp.float32):
    x, dt, A, Bm, Cm = arrs
    j = [jnp.asarray(x, dtype), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(Bm, dtype), jnp.asarray(Cm, dtype)]
    if chunk is None:
        y, h = ops.mamba2_ssd(*j, pad=True)
    else:
        y, h = ops.mamba2_ssd(*j, chunk=chunk)
    return np.asarray(y, np.float32), np.asarray(h, np.float32)


def _torch(arrs, dtype=torch.float32):
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrs)
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


def _plan_chunk(B, S, nh, hd, G, ds):
    return plan_for("mamba2_ssd", {"B": B, "S": S, "nh": nh, "hd": hd,
                                   "ds": ds, "G": G},
                    dtype=jnp.float32, pad=True).blocks["chunk"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_kernel(name):
    B, S, nh, hd, G, ds, chunk = CASES[name]
    arrs = _inputs(B, S, nh, hd, G, ds)
    yp, hp = _pallas(arrs, chunk)
    chunk = chunk or _plan_chunk(B, S, nh, hd, G, ds)
    y, h = mamba2_ssd_plain(*_torch(arrs), chunk=chunk)
    assert y.shape == (B, S, nh, hd) and y.dtype == torch.float32
    assert h.shape == (B, nh, hd, ds) and h.dtype == torch.float32
    _close(y, yp)
    _close(h, hp)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_and_wrapper_match_oracles(name):
    """At the reference's chunk and at the kernel's own (the wrapper's
    CPU path), against both sequential oracles: the final state of the
    ragged cases is not polluted by rows past S."""
    B, S, nh, hd, G, ds, chunk = CASES[name]
    arrs = _inputs(B, S, nh, hd, G, ds, seed=12)
    yr, hr = jax_ref(*(jnp.asarray(a) for a in arrs))
    yt, ht = mamba2_ssd_ref(*_torch(arrs))
    _close(yt, yr, 1e-5)
    _close(ht, hr, 1e-5)
    before = launch_counts()["mamba2_ssd"]
    for y, h in (mamba2_ssd_plain(*_torch(arrs), chunk=chunk or 16),
                 mamba2_ssd(*_torch(arrs))):
        _close(y, yr)
        _close(h, hr)
    assert launch_counts()["mamba2_ssd"] == before   # CPU: no launch


@pytest.mark.parametrize("name", ["two_groups", "ragged_52"])
def test_plain_matches_pallas_kernel_bf16(name):
    B, S, nh, hd, G, ds, chunk = CASES[name]
    arrs = _inputs(B, S, nh, hd, G, ds, seed=13)
    yp, hp = _pallas(arrs, chunk, jnp.bfloat16)
    chunk = chunk or _plan_chunk(B, S, nh, hd, G, ds)
    y, h = mamba2_ssd_plain(*_torch(arrs, torch.bfloat16), chunk=chunk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), yp, rtol=2.0 ** -7,
                               atol=2e-2)
    _close(h, hp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ds", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 130])
def test_four_passes_match_pallas_kernel(S, G, ds, dtype):
    """The plain version's four passes (scores once per group and cum,
    chunk states from zero, the scan over chunks, the outputs) at the
    reference planner's chunk against the Pallas kernel in interpret
    mode, across ragged S, both group counts and every state size."""
    nh = 2 * G
    arrs = _inputs(1, S, nh, 16, G, ds, seed=S + ds + G)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    yp, hp = _pallas(arrs, None, jdt)
    y, h = mamba2_ssd_plain(*_torch(arrs, tdt),
                            chunk=_plan_chunk(1, S, nh, 16, G, ds))
    assert y.dtype == tdt and h.dtype == torch.float32
    if dtype == "float32":
        _close(y, yp)
    else:
        np.testing.assert_allclose(y.float().numpy(), yp, rtol=2.0 ** -7,
                                   atol=2e-2)
    _close(h, hp)


@pytest.mark.parametrize("chunk", [16, CHUNK])
def test_carried_states_equal_the_recurrence(chunk):
    """Passes (b) and (c): the state each chunk starts from equals the
    step-by-step recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T
    (float64) at the chunk's first row, and the final state its last."""
    B, S, nh, hd, G, ds = 2, 300, 4, 16, 2, 32
    x, dt, A, Bm, Cm = _inputs(B, S, nh, hd, G, ds, seed=15)
    hpg = nh // G
    h = np.zeros((B, nh, hd, ds))
    at_row = {}
    for t in range(S):
        if t % chunk == 0:
            at_row[t] = h.copy()
        Bt = np.repeat(Bm[:, t].astype(np.float64), hpg, axis=1)
        h = np.exp(dt[:, t, :, None, None] * A[None, :, None, None]) * h \
            + (dt[:, t, :, None] * x[:, t])[..., None] * Bt[:, :, None, :]
    tx, tdt, tA, tB, tC = _torch((x, dt, A, Bm, Cm))
    cum, dtq, _ = ssd_mod._cum_and_scores(tdt, tA, tB, tC, chunk)
    local = ssd_mod._local_states(tx, dtq, cum, tB, chunk)
    starts, final = ssd_mod._carried_states(local, cum)
    assert starts.shape == (B, -(-S // chunk), nh, hd, ds)
    for c in range(starts.shape[1]):
        np.testing.assert_allclose(starts[:, c].numpy(), at_row[c * chunk],
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(final.numpy(), h, rtol=TOL, atol=TOL)


def test_chunk_does_not_change_the_result():
    """Chunked SSD is exact at any chunk: the kernel's chunk (128) gives
    the reference planner's result (chunk 256) on a 4-chunk sequence."""
    arrs = _inputs(1, 512, 2, 16, 1, 16, seed=14)
    y64, h64 = mamba2_ssd_plain(*_torch(arrs), chunk=CHUNK)
    y256, h256 = mamba2_ssd_plain(*_torch(arrs), chunk=256)
    _close(y64, y256.numpy())
    _close(h64, h256.numpy())


def _args(**over):
    x = torch.zeros((1, 8, 4, 16))
    dt = torch.zeros((1, 8, 4))
    A = -torch.ones((4,))
    Bm = torch.zeros((1, 8, 1, 16))
    args = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Bm.clone()}
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    ({"Bm": torch.zeros((1, 8, 1, 24)), "Cm": torch.zeros((1, 8, 1, 24))},
     "state size ds=24"),
    ({"x": torch.zeros((1, 8, 4, 8))}, "head dim hd=8"),
    ({"Bm": torch.zeros((1, 8, 3, 16)), "Cm": torch.zeros((1, 8, 3, 16))},
     "group count G dividing nh"),
    ({"dt": torch.zeros((1, 7, 4))}, "operands disagree"),
    ({"Cm": torch.zeros((1, 8, 1, 32))}, "of one shape"),
    ({"Bm": torch.zeros((1, 8, 1, 16), dtype=torch.bfloat16),
      "Cm": torch.zeros((1, 8, 1, 16), dtype=torch.bfloat16)},
     "must share one of"),
    ({"dt": torch.zeros((1, 8, 4), dtype=torch.bfloat16)},
     "dt and A must be float32"),
    ({"x": torch.zeros((1, 8, 16, 4)).transpose(2, 3)}, "contiguous"),
    ({"x": torch.zeros((1, 0, 4, 16)), "dt": torch.zeros((1, 0, 4)),
      "Bm": torch.zeros((1, 0, 1, 16)), "Cm": torch.zeros((1, 0, 1, 16))},
     "empty operand"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(over, match):
    a = _args(**over)
    with pytest.raises(ValueError, match=match):
        mamba2_ssd(a["x"], a["dt"], a["A"], a["Bm"], a["Cm"])


def test_wrapper_rejects_other_devices():
    a = {k: v.to("meta") for k, v in _args().items()}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        mamba2_ssd(a["x"], a["dt"], a["A"], a["Bm"], a["Cm"])
