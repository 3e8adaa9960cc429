"""The Mamba-2 mixer against the reference, function by function.

Weights come from the reference's ``init_ssm`` (converted), inputs from
a numpy seed.  Configs: the reduced mamba2-370m (d_model 128, 16 heads
of 16, d_state 16, chunk 32), the same with two B/C groups, and the
reduced jamba-v0.1-52b's SSM layers.

Each function runs on both packages' plain paths; ``ssm_train`` and
``_ssm_prefill_cache`` also run the kernel paths: the reference's Pallas
``mamba2_ssd`` in interpret mode (asserted through
``repro.kernels.dispatch.decision_scope()``; a silent fallback would
match too) against the port's kernel wrapper, whose CPU path is the
kernel's plain version.  There the plain version runs at the chunk the
reference's planner picks for the same shapes (the ``reference_chunk``
fixture), so the two compute the same sums; that another chunk changes
only the rounding is pinned in ``tests/test_torch_mamba2_ssd.py``.

Tolerance: float32 rtol 1e-5 with an absolute floor of rtol times the
reference's largest magnitude (sums in other orders); on the kernel
paths 1e-4, since the Pallas kernel forms the cumulative decay as a
triangular matmul and its products in another order than the plain
version's cumsum, and exp carries those differences into y (the
reference holds its own Pallas path to its plain one at 2e-3).  bfloat16 rtol 2e-2, a
couple of bf16 ulps: the frameworks round the same values at the same
points but from sums taken in different orders.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import dispatch as kdispatch
from repro.kernels.plan import plan_for
from repro.models import blocks as jblocks
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.convert import to_tensor
from repro_torch.kernels import launch_counts
from repro_torch.models import blocks, ssm

# the module (the package re-exports its wrapper under the same name)
ssd_kernel_mod = importlib.import_module("repro_torch.kernels.mamba2_ssd")

RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
KERNEL_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
CONFIGS = ["mamba2", "mamba2_groups2", "jamba"]


@pytest.fixture
def reference_chunk(monkeypatch):
    """Run the kernel wrapper's CPU path at the chunk the reference's
    planner picks for the same shapes (the Pallas path's chunk)."""
    plain = ssd_kernel_mod.mamba2_ssd_plain

    def at_reference_chunk(x, dt, A, Bm, Cm):
        B, S, nh, hd = x.shape
        chunk = plan_for("mamba2_ssd", {"B": B, "S": S, "nh": nh, "hd": hd,
                                        "ds": Bm.shape[3], "G": Bm.shape[2]},
                         dtype=jnp.float32, pad=True).blocks["chunk"]
        return plain(x, dt, A, Bm, Cm, chunk=chunk)

    monkeypatch.setattr(ssd_kernel_mod, "mamba2_ssd_plain",
                        at_reference_chunk)


def _cfgs(name, dtype="float32", kernels=False):
    arch = "jamba-v0.1-52b" if name == "jamba" else "mamba2-370m"
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if name == "mamba2_groups2":
        jcfg = dataclasses.replace(
            jcfg, ssm=dataclasses.replace(jcfg.ssm, n_groups=2))
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, n_groups=2))
    return (dataclasses.replace(jcfg, dtype=dtype, use_pallas=kernels),
            dataclasses.replace(cfg, dtype=dtype, use_kernels=kernels))


@functools.lru_cache(maxsize=None)
def _weights(name, dtype):
    jcfg, _ = _cfgs(name, dtype)
    jw = jssm.init_ssm(jcfg, jax.random.PRNGKey(3))
    return jw, {k: to_tensor(np.asarray(v), "cpu") for k, v in jw.items()}


def _x(cfg, S, dtype, seed):
    a = np.random.default_rng(seed).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch,
                                                                 dtype))


def _close(port, ref, rtol=1e-5):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(ref).max()))


def _ssd_inputs(B, S, nh, hd, G, ds, seed):
    rng = np.random.RandomState(seed)
    arrs = (rng.randn(B, S, nh, hd).astype(np.float32) * 0.5,
            (np.abs(rng.randn(B, S, nh)) * 0.4 + 0.05).astype(np.float32),
            (-np.abs(rng.randn(nh)) - 0.1).astype(np.float32),
            rng.randn(B, S, G, ds).astype(np.float32) * 0.5,
            rng.randn(B, S, G, ds).astype(np.float32) * 0.5)
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a) for a in arrs])


def test_dims_and_split_match_reference():
    for name in CONFIGS:
        jcfg, cfg = _cfgs(name)
        assert ssm.d_inner_of(cfg) == jssm.d_inner_of(jcfg)
        assert ssm._dims(cfg) == jssm._dims(jcfg)
        width = _weights(name, "float32")[1]["in_proj"].shape[1]
        z = np.arange(3 * width, dtype=np.float32).reshape(3, width)
        for a, b in zip(ssm._split_proj(cfg, torch.from_numpy(z)),
                        jssm._split_proj(jcfg, jnp.asarray(z))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_init_ssm_shapes_and_dtypes_match_reference():
    jcfg, cfg = _cfgs("mamba2", "bfloat16")
    jw = jssm.init_ssm(jcfg, jax.random.PRNGKey(0))
    w = ssm.init_ssm(cfg, torch.Generator().manual_seed(0),
                     torch.device("cpu"))
    assert set(w) == set(jw)
    for k in jw:
        assert tuple(w[k].shape) == jw[k].shape, k
        assert str(w[k].dtype).split(".")[1] == jw[k].dtype.name, k
    for k in ("A_log", "D", "dt_bias", "conv_b", "norm"):
        _close(w[k], jw[k])


@pytest.mark.parametrize("dtype", list(RTOL))
def test_conv_train_and_gated_norm_match_reference(dtype):
    jcfg, cfg = _cfgs("mamba2", dtype)
    jw, w = _weights("mamba2", dtype)
    _, _, conv_dim = ssm._dims(cfg)
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 37, conv_dim)).astype(np.float32)
    got = ssm._conv_train(w, torch.from_numpy(a).to(getattr(torch, dtype)),
                          cfg.ssm.d_conv)
    want = jssm._conv_train(jw, jnp.asarray(a, dtype), jcfg.ssm.d_conv)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, RTOL[dtype])
    d_in = ssm.d_inner_of(cfg)
    y, z = (rng.standard_normal((2, 5, d_in)).astype(np.float32)
            for _ in range(2))
    got = ssm._gated_norm(cfg, w["norm"],
                          torch.from_numpy(y).to(getattr(torch, dtype)),
                          torch.from_numpy(z).to(getattr(torch, dtype)))
    want = jssm._gated_norm(jcfg, jw["norm"], jnp.asarray(y, dtype),
                            jnp.asarray(z, dtype))
    _close(got, want, RTOL[dtype])


@pytest.mark.parametrize("S,G,with_h0", [(64, 1, False), (52, 1, False),
                                         (96, 2, False), (52, 1, True),
                                         (64, 2, True)])
def test_ssd_chunked_plain_matches_reference(S, G, with_h0):
    (jx, jdt, jA, jB, jC), (x, dt, A, Bm, Cm) = _ssd_inputs(
        2, S, 4, 16, G, 16, seed=S + G)
    h0 = np.random.default_rng(5).standard_normal(
        (2, 4, 16, 16)).astype(np.float32) if with_h0 else None
    jy, jh = jssm.ssd_chunked(jx, jdt, jA, jB, jC, 32,
                              None if h0 is None else jnp.asarray(h0))
    y, h = ssm.ssd_chunked(x, dt, A, Bm, Cm, 32,
                           None if h0 is None else torch.from_numpy(h0))
    _close(y, jy)
    _close(h, jh)


def test_ssd_chunked_kernel_path_matches_plain():
    (_, _, _, _, _), args = _ssd_inputs(2, 52, 4, 16, 1, 16, seed=6)
    y, h = ssm.ssd_chunked(*args, 32)
    yk, hk = ssm.ssd_chunked(*args, 32, use_kernels=True)
    _close(yk, y.numpy(), 2e-3)
    _close(hk, h.numpy(), 2e-3)


def test_ssd_chunked_kernel_path_refuses_h0():
    """The kernel scans from a zero state; a carried state raises instead
    of falling back to the plain scan."""
    (_, _, _, _, _), args = _ssd_inputs(1, 32, 2, 16, 1, 16, seed=7)
    h0 = torch.ones((1, 2, 16, 16))
    before = launch_counts()["mamba2_ssd"]
    with pytest.raises(NotImplementedError, match="initial state h0"):
        ssm.ssd_chunked(*args, 32, h0, use_kernels=True)
    assert launch_counts()["mamba2_ssd"] == before


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_step_matches_reference(G):
    rng = np.random.default_rng(8 + G)
    B, nh, hd, ds = 3, 4, 16, 16
    arrs = (rng.standard_normal((B, nh, hd)).astype(np.float32),
            (np.abs(rng.standard_normal((B, nh))) * 0.4 + 0.05)
            .astype(np.float32),
            (-np.abs(rng.standard_normal(nh)) - 0.1).astype(np.float32),
            rng.standard_normal((B, G, ds)).astype(np.float32),
            rng.standard_normal((B, G, ds)).astype(np.float32),
            rng.standard_normal((B, nh, hd, ds)).astype(np.float32))
    jy, jh = jssm.ssd_step(*(jnp.asarray(a) for a in arrs))
    y, h = ssm.ssd_step(*(torch.from_numpy(a) for a in arrs))
    _close(y, jy)
    _close(h, jh)


def _reference_ran(decisions, kernels):
    dec = decisions.get("mamba2_ssd")
    if kernels:
        assert dec is not None and dec.use_kernel, dec
    else:
        assert dec is None


TRAIN_CASES = [(n, S, d, k) for n in CONFIGS for S in (64, 52)
               for d, k in (("float32", False), ("float32", True))] + \
    [("mamba2", 52, "bfloat16", False), ("mamba2", 52, "bfloat16", True)]


@pytest.mark.parametrize("name,S,dtype,kernels", TRAIN_CASES)
def test_ssm_train_matches_reference(name, S, dtype, kernels,
                                     reference_chunk):
    jcfg, cfg = _cfgs(name, dtype, kernels)
    jw, w = _weights(name, dtype)
    jx, x = _x(cfg, S, dtype, seed=S)
    with kdispatch.decision_scope() as decisions:
        want = jssm.ssm_train(jcfg, jw, jx)
    _reference_ran(decisions, kernels)
    got = ssm.ssm_train(cfg, w, x)
    assert got.shape == x.shape and got.dtype == x.dtype
    _close(got, want, (KERNEL_RTOL if kernels else RTOL)[dtype])


@pytest.mark.parametrize("name,kernels", [(n, k) for n in CONFIGS
                                          for k in (False, True)])
def test_ssm_prefill_cache_matches_reference(name, kernels,
                                            reference_chunk):
    jcfg, cfg = _cfgs(name, "float32", kernels)
    jw, w = _weights(name, "float32")
    jx, x = _x(cfg, 45, "float32", seed=9)
    with kdispatch.decision_scope() as decisions:
        want = jblocks._ssm_prefill_cache(jcfg, jw, jx)
    _reference_ran(decisions, kernels)
    got = blocks._ssm_prefill_cache(cfg, w, x)
    assert set(got) == {"conv", "state"}
    assert got["conv"].shape == (2, cfg.ssm.d_conv - 1, ssm._dims(cfg)[2])
    assert got["conv"].is_contiguous()
    _close(got["conv"], want["conv"])
    _close(got["state"], want["state"],
           (KERNEL_RTOL if kernels else RTOL)["float32"])


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype", list(RTOL))
def test_ssm_decode_matches_reference_and_updates_in_place(name, dtype):
    jcfg, cfg = _cfgs(name, dtype)
    jw, w = _weights(name, dtype)
    rng = np.random.default_rng(10)
    jcache = jssm.init_ssm_cache(jcfg, 2)
    conv = rng.standard_normal(jcache["conv"].shape).astype(np.float32)
    state = rng.standard_normal(jcache["state"].shape).astype(np.float32)
    jcache = {"conv": jnp.asarray(conv, dtype), "state": jnp.asarray(state)}
    cache = ssm.init_ssm_cache(cfg, 2, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in cache.items()} == \
        {k: (v.shape, v.dtype.name) for k, v in jcache.items()}
    cache["conv"].copy_(torch.from_numpy(conv))
    cache["state"].copy_(torch.from_numpy(state))
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    jx, x = _x(cfg, 1, dtype, seed=11)
    want, jnew = jssm.ssm_decode(jcfg, jw, jx, jcache, jnp.int32(7))
    got, new = ssm.ssm_decode(cfg, w, x, cache, 7)
    assert new is cache
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    _close(got, want, RTOL[dtype])
    _close(cache["conv"], jnew["conv"], RTOL[dtype])
    _close(cache["state"], jnew["state"], RTOL[dtype])
