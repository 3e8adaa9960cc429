"""The model's serving steps against the reference.

The sync engine's steps (``forward`` in mode train, ``prefill`` with its
padded cache, and one ``decode_step`` from the reference's prefill cache
carried over by ``convert_cache``) run on the reduced qwen2-7b with the
reference's weights (converted), in float32 and bfloat16, on both paths:
the reference's ``use_pallas=False`` against the port's
``use_kernels=False``, and the reference's Pallas kernels (interpret
mode) against the port's kernels (their plain versions on the CPU).
Tolerance: float32 rtol 1e-5; bfloat16 rtol 2e-2, a couple of bf16 ulps
(the frameworks round activations to bf16 in different places, on the
plain paths as much as on the kernel paths); both with an absolute floor
of rtol times the reference's largest magnitude.

The paged steps, ``paged_decode_step`` and ``paged_prefill_step``, run in
float32 with the same random pools, tables and lengths; the reference
runs its ``use_pallas=False`` path.  The port runs both of its paths:
``use_kernels=True`` (the kernel's plain version on the CPU) and
``use_kernels=False`` (gather plus plain attention).  Logits and every
pool row must agree to rtol 1e-5.  Prefill covers both write paths: the
aligned single-block window and the row scatter that sends padded rows
to the null block.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import dispatch as kdispatch
from repro.models import init_params as jax_init_params
from repro.models.blocks import schedule as jax_schedule
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import forward as jax_forward
from repro.models.model import paged_decode_step as jax_decode
from repro.models.model import paged_prefill_step as jax_prefill
from repro.models.model import prefill as jax_sync_prefill
from repro_torch.configs import get_config
from repro_torch.convert import convert_cache, convert_params
from repro_torch.models import (decode_step, forward, paged_decode_step,
                                paged_prefill_step, prefill)

from _torch_catalog import xla_cpu_silu

JCFG = dataclasses.replace(jax_get_config("qwen2-7b").reduced(),
                           dtype="float32")
CFG = dataclasses.replace(get_config("qwen2-7b").reduced(), dtype="float32")
JPARAMS = jax_init_params(JCFG, jax.random.PRNGKey(0))
PARAMS = convert_params(jax.tree.map(np.asarray, JPARAMS), device="cpu")
PAGE, P = 128, 7
RTOL = 1e-5
SYNC_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _close(port, ref, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(ref).max()))


@functools.lru_cache(maxsize=None)
def _sync_models(dtype, kernels):
    """(reference cfg, reference params, port cfg, port params) with the
    reference's Pallas path and the port's kernel path both on or off."""
    jcfg = dataclasses.replace(JCFG, dtype=dtype, use_pallas=kernels)
    cfg = dataclasses.replace(CFG, dtype=dtype, use_kernels=kernels)
    if dtype == JCFG.dtype:
        return jcfg, JPARAMS, cfg, PARAMS
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, convert_params(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _reference_ran(decisions, kernel, kernels):
    """With ``kernels`` the reference's Pallas kernel really ran (a
    silent fallback would give matching outputs too)."""
    dec = decisions.get(kernel)
    if kernels:
        assert dec is not None and dec.use_kernel, f"{kernel}: {dec}"
    else:
        assert dec is None


SYNC_CASES = [(d, k) for d in SYNC_RTOL for k in (False, True)]
SYNC_IDS = [f"{d}-{'kernels' if k else 'plain'}" for d, k in SYNC_CASES]


@pytest.mark.parametrize("dtype,kernels", SYNC_CASES, ids=SYNC_IDS)
def test_forward_train_matches_reference(dtype, kernels):
    jcfg, jparams, cfg, params = _sync_models(dtype, kernels)
    toks = np.random.default_rng(7).integers(
        0, CFG.vocab_size, (2, 45)).astype(np.int32)
    with kdispatch.decision_scope() as decisions:
        jl, _ = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                            mode="train")
    _reference_ran(decisions, "flash_attention", kernels)
    tl, aux = forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                      mode="train")
    assert tl.shape == (2, 45, CFG.vocab_size) and tl.dtype == torch.float32
    assert float(aux) == 0.0
    _close(tl, jl, SYNC_RTOL[dtype])


@pytest.mark.parametrize("dtype,kernels", SYNC_CASES, ids=SYNC_IDS)
def test_prefill_and_decode_step_match_reference(dtype, kernels):
    """Prefill logits and the padded cache of every layer; then one
    decode step on both sides from the reference's cache, carried over
    by ``convert_cache``: logits and the updated cache."""
    jcfg, jparams, cfg, params = _sync_models(dtype, kernels)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, CFG.vocab_size, (2, 37)).astype(np.int32)
    nxt = rng.integers(0, CFG.vocab_size, (2, 1)).astype(np.int32)
    max_len, rtol = 64, SYNC_RTOL[dtype]
    with kdispatch.decision_scope() as decisions:
        jl, jcache = jax_sync_prefill(jcfg, jparams,
                                      {"tokens": jnp.asarray(toks)}, max_len)
    _reference_ran(decisions, "flash_attention", kernels)
    tl, cache = prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                        max_len)
    assert tl.shape == (2, 1, CFG.vocab_size)
    _close(tl, jl, rtol)
    np_cache = jax.tree.map(np.asarray, jcache)
    want = convert_cache(np_cache, device="cpu")
    assert len(cache) == len(want) == CFG.n_layers
    for got, ref in zip(cache, want):
        for n in "kv":
            assert got[n].shape == (2, max_len, CFG.n_kv_heads, CFG.hd)
            _close(got[n], ref[n].float().numpy(), rtol)
    with kdispatch.decision_scope() as decisions:
        jdl, jnew = jax_decode_step(jcfg, jparams, jcache, jnp.asarray(nxt),
                                    jnp.int32(37))
    _reference_ran(decisions, "decode_attention", kernels)
    carried = convert_cache(np_cache, device="cpu")
    tdl, new = decode_step(cfg, params, carried, torch.from_numpy(nxt), 37)
    assert new is carried                       # written in place
    _close(tdl, jdl, rtol)
    for got, ref in zip(new, convert_cache(jax.tree.map(np.asarray, jnew),
                                           device="cpu")):
        for n in "kv":
            _close(got[n], ref[n].float().numpy(), rtol)


def _pools(seed):
    rng = np.random.default_rng(seed)
    shp = (CFG.n_layers, P, PAGE, CFG.n_kv_heads, CFG.hd)
    return {n: rng.standard_normal(shp).astype(np.float32) for n in "kv"}


def _both(pools_np):
    jpools = {"layers0": [], "layers": ({n: jnp.asarray(a)
                                         for n, a in pools_np.items()},)}
    tpools = {n: torch.from_numpy(a.copy()) for n, a in pools_np.items()}
    return jpools, tpools


def _check_pools(tpools, jnew):
    for n in "kv":
        _close(tpools[n], jnew["layers"][0][n])


@pytest.mark.parametrize("use_kernels", [True, False])
def test_paged_decode_step_matches_reference(use_kernels):
    pools = _pools(1)
    # ragged lengths: two pages and a partial third row, a page boundary
    # write, a short request, and an idle slot on the null block
    tables = np.array([[1, 2, 0], [3, 0, 0], [4, 5, 6], [0, 0, 0]], np.int32)
    lens = np.array([150, 40, 256, 0], np.int32)
    toks = np.random.default_rng(1).integers(
        0, CFG.vocab_size, (4, 1)).astype(np.int32)
    jpools, tpools = _both(pools)
    jl, jnew = jax_decode(JCFG, JPARAMS, jpools, jnp.asarray(toks),
                          jnp.asarray(tables), jnp.asarray(lens))
    cfg = dataclasses.replace(CFG, use_kernels=use_kernels)
    tl = paged_decode_step(cfg, PARAMS, tpools, torch.from_numpy(toks),
                           torch.from_numpy(tables), torch.from_numpy(lens))
    assert tl.shape == (4, 1, CFG.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl)
    _check_pools(tpools, jnew)


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned_window", "row_scatter"])
def test_paged_prefill_step_matches_reference(aligned):
    rng = np.random.default_rng(2)
    if aligned:
        # B == 1, a 32-row chunk at offset 64 inside block 3, 20 valid
        tables = np.array([[5, 3, 0]], np.int32)
        lens = np.array([160], np.int32)
        nv = np.array([20], np.int32)
        C = 32
    else:
        # request 0 crosses a page boundary (100..147); request 1 is a
        # 30-row first chunk whose padded rows go to the null block
        tables = np.array([[1, 2, 0], [4, 0, 0]], np.int32)
        lens = np.array([100, 0], np.int32)
        nv = np.array([48, 30], np.int32)
        C = 48
    toks = rng.integers(0, CFG.vocab_size, (len(lens), C)).astype(np.int32)
    jpools, tpools = _both(_pools(3))
    jl, jnew = jax_prefill(JCFG, JPARAMS, jpools, jnp.asarray(toks),
                           jnp.asarray(tables), jnp.asarray(lens),
                           jnp.asarray(nv), aligned=aligned)
    tl = paged_prefill_step(CFG, PARAMS, tpools, torch.from_numpy(toks),
                            torch.from_numpy(tables), torch.from_numpy(lens),
                            torch.from_numpy(nv), aligned=aligned)
    assert tl.shape == (len(lens), 1, CFG.vocab_size)
    _close(tl, jl)
    _check_pools(tpools, jnew)


def test_prefill_then_decode_continues_the_sequence():
    """Prefilling a prompt and decoding its next token through the pool
    gives the logits a one-shot prefill of the longer prompt gives."""
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, CFG.vocab_size, (1, 37)).astype(np.int32)
    tables = torch.tensor([[2, 0, 0]], dtype=torch.int32)
    _, pools = _both(_pools(5))
    paged_prefill_step(CFG, PARAMS, pools, torch.from_numpy(prompt[:, :36]),
                       tables, torch.tensor([0], dtype=torch.int32),
                       torch.tensor([36], dtype=torch.int32))
    step = paged_decode_step(CFG, PARAMS, pools,
                             torch.from_numpy(prompt[:, 36:]), tables,
                             torch.tensor([36], dtype=torch.int32))
    _, fresh = _both(_pools(6))
    whole = paged_prefill_step(CFG, PARAMS, fresh, torch.from_numpy(prompt),
                               tables, torch.tensor([0], dtype=torch.int32),
                               torch.tensor([37], dtype=torch.int32))
    _close(step, whole.numpy())


# -- MoE: the reduced qwen3-moe-235b-a22b (4 experts, top-2) ----------------
#
# Held in float32 on both paths (rtol 1e-5).  In bfloat16 a whole-model
# comparison is not meaningful: a token whose top-2 experts are within
# rounding noise routes differently under different rounding, and the
# reference's own bf16 run differs from its f32 run by up to 0.3 of the
# logits' scale at such tokens.  bf16 is held where the inputs are
# shared, per MoE layer (tests/test_torch_moe.py), and end to end by the
# engines' near-tie rule (tests/test_torch_engine.py,
# tests/test_torch_paged_engine.py).

MOE = "qwen3-moe-235b-a22b"
MOE_CASES = [True, False]
MOE_IDS = ["kernels", "plain"]


@functools.lru_cache(maxsize=None)
def _moe_models(dtype, kernels):
    """(reference cfg, reference params, port cfg, port params) of the
    reduced MoE model, both kernel paths on or off."""
    jcfg = dataclasses.replace(jax_get_config(MOE).reduced(), dtype=dtype,
                               use_pallas=kernels)
    cfg = dataclasses.replace(get_config(MOE).reduced(), dtype=dtype,
                              use_kernels=kernels)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    return jcfg, jparams, cfg, convert_params(
        jax.tree.map(np.asarray, jparams), device="cpu")


def test_convert_carries_moe_leaves():
    """The stacked MoE leaves come out one per layer: the router in f32,
    the experts' weights with their leading E axis, bit for bit."""
    _, jparams, cfg, params = _moe_models("bfloat16", False)
    m, D = cfg.moe, cfg.d_model
    assert len(params["layers"]) == cfg.n_layers
    stacked = jparams["layers"][0]["ffn"]
    for i, layer in enumerate(params["layers"]):
        ffn = layer["ffn"]
        assert set(ffn) == {"router", "we_g", "we_i", "we_o"}
        assert ffn["router"].dtype == torch.float32
        assert ffn["router"].shape == (D, m.n_experts)
        assert ffn["we_g"].shape == ffn["we_i"].shape == \
            (m.n_experts, D, m.d_ff_expert)
        assert ffn["we_o"].shape == (m.n_experts, m.d_ff_expert, D)
        for name in ("we_g", "we_i", "we_o"):
            assert ffn[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                ffn[name].float().numpy(),
                np.asarray(stacked[name][i], np.float32))


@pytest.mark.parametrize("kernels", MOE_CASES, ids=MOE_IDS)
def test_moe_forward_train_matches_reference(kernels):
    jcfg, jparams, cfg, params = _moe_models("float32", kernels)
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 45)).astype(np.int32)
    with kdispatch.decision_scope() as decisions:
        jl, jaux = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                               mode="train")
    _reference_ran(decisions, "moe_gmm", kernels)
    tl, aux = forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                      mode="train")
    assert tl.shape == (2, 45, cfg.vocab_size) and tl.dtype == torch.float32
    assert float(aux) > 0.0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    _close(tl, jl)


@pytest.mark.parametrize("kernels", MOE_CASES, ids=MOE_IDS)
def test_moe_prefill_and_decode_step_match_reference(kernels):
    jcfg, jparams, cfg, params = _moe_models("float32", kernels)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    max_len, rtol = 64, RTOL
    with kdispatch.decision_scope() as decisions:
        jl, jcache = jax_sync_prefill(jcfg, jparams,
                                      {"tokens": jnp.asarray(toks)}, max_len)
    _reference_ran(decisions, "moe_gmm", kernels)
    tl, cache = prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                        max_len)
    _close(tl, jl, rtol)
    np_cache = jax.tree.map(np.asarray, jcache)
    for got, ref in zip(cache, convert_cache(np_cache, device="cpu")):
        for n in "kv":
            _close(got[n], ref[n].float().numpy(), rtol)
    with kdispatch.decision_scope() as decisions:
        jdl, _ = jax_decode_step(jcfg, jparams, jcache, jnp.asarray(nxt),
                                 jnp.int32(37))
    _reference_ran(decisions, "moe_gmm", kernels)
    tdl, _ = decode_step(cfg, params, convert_cache(np_cache, device="cpu"),
                         torch.from_numpy(nxt), 37)
    _close(tdl, jdl, rtol)


@pytest.mark.parametrize("kernels", MOE_CASES, ids=MOE_IDS)
def test_moe_paged_steps_match_reference(kernels):
    """A decode tick over ragged slots, then a right-padded prefill
    chunk (30 valid rows of 48) on the pools it wrote.  The reference
    runs its plain path (its paged steps take no Pallas kernel)."""
    jcfg, jparams, cfg, params = _moe_models("float32", False)
    cfg = dataclasses.replace(cfg, use_kernels=kernels)
    pools = _pools(11)
    tables = np.array([[1, 2, 0], [3, 0, 0], [4, 5, 6], [0, 0, 0]], np.int32)
    lens = np.array([150, 40, 256, 0], np.int32)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
    jpools, tpools = _both(pools)
    jl, jnew = jax_decode(jcfg, jparams, jpools, jnp.asarray(toks),
                          jnp.asarray(tables), jnp.asarray(lens))
    tl = paged_decode_step(cfg, params, tpools, torch.from_numpy(toks),
                           torch.from_numpy(tables), torch.from_numpy(lens))
    _close(tl, jl)
    _check_pools(tpools, jnew)
    ptables = np.array([[1, 2, 0], [4, 0, 0]], np.int32)
    plens = np.array([100, 0], np.int32)
    nv = np.array([48, 30], np.int32)
    ptoks = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    jl, jnew = jax_prefill(jcfg, jparams, jnew, jnp.asarray(ptoks),
                           jnp.asarray(ptables), jnp.asarray(plens),
                           jnp.asarray(nv))
    tl = paged_prefill_step(cfg, params, tpools, torch.from_numpy(ptoks),
                            torch.from_numpy(ptables), torch.from_numpy(plens),
                            torch.from_numpy(nv))
    _close(tl, jl)
    _check_pools(tpools, jnew)


# -- SSM and hybrid: the reduced mamba2-370m and jamba-v0.1-52b --------------
#
# mamba2 in float32 and bfloat16, jamba in float32 only as a whole model
# (in bfloat16 it is held layer by layer, below).  On the
# kernel paths the port's mamba2_ssd wrapper runs its plain version at
# the chunk the reference's planner picks for the same shapes (the
# ``reference_chunk`` fixture).
#
# float32: rtol 1e-4 (absolute floor as above).  A chunk's cumulative
# log-decay sums up to 32 terms and reaches hundreds in magnitude; each
# decay is the exp of a difference of two such sums, so one ulp of a sum
# taken in another order is a ~3e-5 relative change of a decay, and the
# state carries it across chunks and layers.
# bfloat16: the frameworks round the same values at the same points but
# from sums in other orders, and over four SSM layers a one-ulp flip of
# an activation grows to a few percent of some logits: the reference's
# own bf16 run lies 2.1% (relative norm) from a float32 run of the same
# weights.  So each bf16 output is held by the float32 yardstick that
# chip_smoke.py uses on the card: within 5e-2 relative norm of the
# reference's bf16 output, and no further from the port's float32 run
# of the same (upcast) weights and state than 1.5x the reference is.

SSM_ARCHS = {"mamba2": ("mamba2-370m", 2), "jamba": ("jamba-v0.1-52b", 3)}
SSM_CASES = [("mamba2", "float32", False), ("mamba2", "float32", True),
             ("mamba2", "bfloat16", False), ("mamba2", "bfloat16", True),
             ("jamba", "float32", False), ("jamba", "float32", True)]
SSM_IDS = [f"{a}-{d}-{'kernels' if k else 'plain'}" for a, d, k in SSM_CASES]
SSM_RTOL = 1e-4
BF16_REL = 5e-2


def _upcast(tree):
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_upcast(v) for v in tree]
    return tree.float() if tree.dtype == torch.bfloat16 else tree


def _held(port, ref, f32=None):
    """float32 (``f32`` None): elementwise at ``SSM_RTOL``.  bfloat16:
    the yardstick rule above, ``f32`` the port's float32 output."""
    if f32 is None:
        _close(port, ref, SSM_RTOL)
        return
    a, b, c = (np.asarray(t.float().numpy() if torch.is_tensor(t) else t,
                          np.float32) for t in (port, ref, f32))
    assert np.isfinite(a).all()

    def rel(u, v):
        return np.linalg.norm(u - v) / max(np.linalg.norm(v), 1e-30)

    assert rel(a, b) < BF16_REL, (rel(a, b), BF16_REL)
    assert rel(a, c) <= 1.5 * rel(b, c) + 1e-6, (rel(a, c), rel(b, c))


@pytest.fixture
def reference_chunk(monkeypatch):
    """Run the SSD kernel wrapper's CPU path at the reference planner's
    chunk for the same shapes (the Pallas path's chunk)."""
    import importlib
    from repro.kernels.plan import plan_for
    mod = importlib.import_module("repro_torch.kernels.mamba2_ssd")
    plain = mod.mamba2_ssd_plain

    def at_reference_chunk(x, dt, A, Bm, Cm):
        B, S, nh, hd = x.shape
        chunk = plan_for("mamba2_ssd", {"B": B, "S": S, "nh": nh, "hd": hd,
                                        "ds": Bm.shape[3], "G": Bm.shape[2]},
                         dtype=jnp.float32, pad=True).blocks["chunk"]
        return plain(x, dt, A, Bm, Cm, chunk=chunk)

    monkeypatch.setattr(mod, "mamba2_ssd_plain", at_reference_chunk)


@functools.lru_cache(maxsize=None)
def _ssm_models(name, dtype, kernels):
    arch, seed = SSM_ARCHS[name]
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype,
                               use_pallas=kernels)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                              use_kernels=kernels)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jparams, cfg, convert_params(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _n_attn(cfg):
    return sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))


def _f32_twin(cfg, params):
    """The port's plain path in float32 on the same weights, upcast."""
    return dataclasses.replace(cfg, dtype="float32", use_kernels=False), \
        _upcast(params)


def _held_cache(cache, want, f32_cache=None):
    assert len(cache) == len(want)
    for i, (got, ref) in enumerate(zip(cache, want)):
        assert set(got) == set(ref)
        for n in got:
            assert got[n].shape == ref[n].shape and \
                got[n].dtype == ref[n].dtype, n
            _held(got[n], ref[n].float().numpy(),
                  None if f32_cache is None else f32_cache[i][n])


@pytest.mark.parametrize("name,dtype,kernels", SSM_CASES, ids=SSM_IDS)
def test_ssm_forward_train_matches_reference(name, dtype, kernels,
                                             reference_chunk):
    jcfg, jparams, cfg, params = _ssm_models(name, dtype, kernels)
    toks = np.random.default_rng(13).integers(
        0, cfg.vocab_size, (2, 45)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks)}
    with kdispatch.decision_scope() as decisions:
        jl, jaux = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                               mode="train")
    _reference_ran(decisions, "mamba2_ssd", kernels)
    if _n_attn(cfg):
        _reference_ran(decisions, "flash_attention", kernels)
    tl, aux = forward(cfg, params, batch, mode="train")
    assert tl.shape == (2, 45, cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=0)
    f32 = None
    if dtype == "bfloat16":
        f32 = forward(*_f32_twin(cfg, params), batch, mode="train")[0]
    _held(tl, jl, f32)


@pytest.mark.parametrize("name,dtype,kernels", SSM_CASES, ids=SSM_IDS)
def test_ssm_prefill_and_decode_step_match_reference(name, dtype, kernels,
                                                     reference_chunk):
    """Prefill logits and every layer's cache ({"conv", "state"} for SSM
    layers, padded K/V for attention ones); then one decode step on both
    sides from the reference's cache carried over by ``convert_cache``,
    updated in place on the port's side."""
    jcfg, jparams, cfg, params = _ssm_models(name, dtype, kernels)
    rng = np.random.default_rng(14)
    toks = rng.integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    batch, max_len = {"tokens": torch.from_numpy(toks)}, 64
    with kdispatch.decision_scope() as decisions:
        jl, jcache = jax_sync_prefill(jcfg, jparams,
                                      {"tokens": jnp.asarray(toks)}, max_len)
    _reference_ran(decisions, "mamba2_ssd", kernels)
    tl, cache = prefill(cfg, params, batch, max_len)
    np_cache = jax.tree.map(np.asarray, jcache)
    f32_l = f32_cache = f32_dl = f32_new = None
    if dtype == "bfloat16":
        f32_cfg, f32_params = _f32_twin(cfg, params)
        f32_l, f32_cache = prefill(f32_cfg, f32_params, batch, max_len)
        f32_new = _upcast(convert_cache(np_cache, device="cpu"))
        f32_dl, _ = decode_step(f32_cfg, f32_params, f32_new,
                                torch.from_numpy(nxt), 37)
    _held(tl, jl, f32_l)
    _held_cache(cache, convert_cache(np_cache, device="cpu"), f32_cache)
    jdl, jnew = jax_decode_step(jcfg, jparams, jcache, jnp.asarray(nxt),
                                jnp.int32(37))
    carried = convert_cache(np_cache, device="cpu")
    ptrs = [{n: t.data_ptr() for n, t in c.items()} for c in carried]
    tdl, new = decode_step(cfg, params, carried, torch.from_numpy(nxt), 37)
    assert new is carried
    assert [{n: t.data_ptr() for n, t in c.items()} for c in new] == ptrs
    _held(tdl, jdl, f32_dl)
    _held_cache(new, convert_cache(jax.tree.map(np.asarray, jnew),
                                   device="cpu"), f32_new)
# jamba in bfloat16, layer by layer.  Whole-model bf16 jamba is not held
# to the reference on the CPU (ROADMAP queue 3): over its 8 layers it
# lies 6.5% (relative norm) from the reference's bf16 output, past the
# 5e-2 yardstick, and the sync engine's streams part above the near-tie
# margin.  The one rounding point that differs is the SwiGLU's SiLU in
# the dense FFN layers.  ``jax.nn.silu`` is x * logistic(x), and XLA:CPU
# evaluates a bf16 logistic as exp(-x), 1 + e and 1 / (1 + e), each
# rounded to bf16, then rounds once more before the product; the port's
# ``F.silu`` rounds once from f32.  So, fed the reference's own input,
# each layer of the port gives the reference's bf16 output on all but a
# handful of elements once its SiLU is evaluated the XLA:CPU way, while
# with its own SiLU the dense FFN layers differ by more than one bf16 ulp
# at about a quarter of their outputs.  The rest of the whole-model gap
# is those few flips and f32 sums in other orders, amplified by random
# weights and MoE routing near-ties.

def _beyond_one_ulp(port, ref) -> float:
    """Fraction of bf16 outputs more than one bf16 ulp apart."""
    a, b = port.float().numpy(), np.asarray(ref, np.float32)
    m = np.maximum(np.abs(a), np.abs(b))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(m, 2.0 ** -126))) - 7)
    return float((np.abs(a - b) > ulp).mean())


@pytest.mark.parametrize("kernels", [False, True],
                         ids=["plain", "kernels"])
def test_jamba_bf16_layers_match_reference_but_for_silu(kernels,
                                                        reference_chunk,
                                                        monkeypatch):
    from repro.models.blocks import apply_layer as jax_apply_layer
    from repro.models.blocks import layer_sigs as jax_layer_sigs
    from repro.models.model import _embed_in as jax_embed_in
    from repro_torch.models.blocks import apply_layer, layer_sigs
    jcfg, jparams, cfg, params = _ssm_models("jamba", "bfloat16", kernels)
    toks = np.random.default_rng(13).integers(
        0, cfg.vocab_size, (2, 45)).astype(np.int32)
    first_k, period, n_periods = jax_schedule(jcfg)
    assert first_k == 0
    ws = [jax.tree.map(lambda x: x[p], jparams["layers"])[s]
          for p in range(n_periods) for s in range(period)]
    pos_j = jnp.arange(45, dtype=jnp.int32)
    pos = torch.arange(45, dtype=torch.int32)
    h = jax_embed_in(jcfg, jparams, jnp.asarray(toks))
    silu = torch.nn.functional.silu
    for i, (sig, jw, w) in enumerate(zip(jax_layer_sigs(jcfg), ws,
                                         params["layers"])):
        assert layer_sigs(cfg)[i] == sig
        want, _ = jax_apply_layer(jcfg, sig, jw, h, mode="train",
                                  positions=pos_j)
        x = torch.from_numpy(np.asarray(h, np.float32)).to(torch.bfloat16)
        own = _beyond_one_ulp(apply_layer(cfg, sig, w, x, mode="train",
                                          positions=pos)[0], want)
        monkeypatch.setattr(torch.nn.functional, "silu",
                            xla_cpu_silu(silu))
        emulated = _beyond_one_ulp(apply_layer(cfg, sig, w, x,
                                               mode="train",
                                               positions=pos)[0], want)
        monkeypatch.setattr(torch.nn.functional, "silu", silu)
        if kernels and sig[0] == "attn":
            # flash attention's plain version and the Pallas kernel agree
            # to one ulp of the attention output (their own test), which
            # the output projection spreads over more elements
            h = want
            continue
        assert emulated < 2e-3, (i, sig, emulated)
        if sig[1]:                  # an MoE FFN: no bf16 SiLU
            assert own < 2e-3, (i, sig, own)
        else:                       # the dense SwiGLU: the rounding point
            assert own > 5e-2, (i, sig, own)
        h = want


@pytest.mark.parametrize("name,kernels", [("mamba2", False),
                                          ("mamba2", True),
                                          ("jamba", False), ("jamba", True)])
def test_ssm_prefill_then_decode_continues_the_sequence(name, kernels):
    """State handoff: decoding token S-1 after a prefill of S-1 tokens
    gives forward's last logits over all S (float32; the prefill scan is
    chunked, the decode step a recurrence, so rtol 1e-4)."""
    _, _, cfg, params = _ssm_models(name, "float32", kernels)
    toks = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32))
    full, _ = forward(cfg, params, {"tokens": toks}, mode="train")
    _, cache = prefill(cfg, params, {"tokens": toks[:, :39]}, max_len=48)
    step, _ = decode_step(cfg, params, cache, toks[:, 39:], 39)
    _close(step[:, 0], full[:, -1].numpy(), 1e-4)


@pytest.mark.parametrize("name", list(SSM_ARCHS))
def test_convert_cache_carries_ssm_leaves(name):
    """The reference's stacked decode cache comes out one dict per layer
    in global order, bit for bit: {"conv", "state"} for SSM layers (the
    state in f32), {"k", "v"} for jamba's attention layers, each slot of
    a period unstacked."""
    jcfg, _, cfg, _ = _ssm_models(name, "bfloat16", False)
    from repro.models.model import init_cache as jax_init_cache
    jcache = jax_init_cache(jcfg, 2, 16)
    rng = np.random.default_rng(16)
    np_cache = jax.tree.map(
        lambda a: np.asarray(jnp.asarray(rng.standard_normal(a.shape),
                                         a.dtype)), jcache)
    cache = convert_cache(np_cache, device="cpu")
    assert len(cache) == cfg.n_layers
    _, period, _ = jax_schedule(jcfg)
    for i, layer in enumerate(cache):
        slot = np_cache["layers"][i % period]
        kind = cfg.layer_kind(i)
        assert set(layer) == ({"conv", "state"} if kind == "ssm"
                              else {"k", "v"})
        for n, t in layer.items():
            ref = slot[n][i // period]
            assert tuple(t.shape) == ref.shape
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(ref, np.float32))
        if kind == "ssm":
            assert layer["state"].dtype == torch.float32
            assert layer["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", list(SSM_ARCHS))
def test_convert_params_carries_ssm_leaves(name):
    jcfg, jparams, cfg, params = _ssm_models(name, "bfloat16", False)
    _, period, _ = jax_schedule(jcfg)
    assert len(params["layers"]) == cfg.n_layers
    for i, layer in enumerate(params["layers"]):
        ref = jparams["layers"][i % period]
        if cfg.layer_kind(i) == "ssm":
            for n in ("in_proj", "conv_w", "A_log", "D", "dt_bias", "norm",
                      "out_proj"):
                got, want = layer["mixer"][n], ref["mixer"][n][i // period]
                assert str(got.dtype).split(".")[1] == want.dtype.name, n
                np.testing.assert_array_equal(got.float().numpy(),
                                              np.asarray(want, np.float32))
        else:
            assert set(layer["mixer"]) == {"wq", "wk", "wv", "wo"}
    assert ("unembed" in params) == (not cfg.tie_embeddings)


def test_paged_steps_refuse_ssm_layers():
    """The paged layer steps page attention layers only, as the
    reference's: an SSM layer raises instead of mixing cache layouts."""
    from repro_torch.models.blocks import (apply_layer_paged,
                                           apply_layer_prefill_paged)
    _, _, cfg, params = _ssm_models("jamba", "float32", False)
    w = params["layers"][0]
    assert cfg.layer_kind(0) == "ssm"
    h = torch.zeros((1, 1, cfg.d_model))
    tables = torch.zeros((1, 1), dtype=torch.int32)
    lens = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="only plain GQA"):
        apply_layer_paged(cfg, ("ssm", True), w, h, {}, tables, lens)
    with pytest.raises(NotImplementedError, match="only plain GQA"):
        apply_layer_prefill_paged(cfg, ("ssm", True), w, h, {}, tables,
                                  lens, lens + 1)
