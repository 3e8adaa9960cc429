"""The MoE layer against the reference's, piece by piece, on the CPU.

Config: the reduced qwen3-moe-235b-a22b (4 experts, top-2, d_model 128,
d_ff_expert 64), and a variant with two shared experts for the branch no
served config uses yet.  Weights come from the reference's ``init_moe``
and are converted; inputs are drawn from a numpy seed.

* ``capacity``, ``router_topk`` (gates, indices, aux loss; tied router
  probabilities must break toward the lower expert as ``jax.lax.top_k``
  breaks them), ``_slot_maps`` (positions, capacity drops, the sink slot
  that the reference's ``mode="drop"`` scatter maps to); slot buffers
  of min(C, S) rows an expert keep what the reference's C rows keep.
* ``moe_apply`` on both paths: the port's ``use_kernels=False`` against
  the reference's ``use_pallas=False``, and the port's kernel path (the
  kernel's plain version on the CPU) against the reference's Pallas
  ``moe_gmm`` in interpret mode, which must really have run.

Tolerances: float32 rtol 1e-5 (summation order); bfloat16 rtol 2e-2, a
couple of bf16 ulps (the frameworks round the gathered and combined
activations at different points), both with an absolute floor of rtol
times the reference's largest magnitude.  Integer maps must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import dispatch as kdispatch
from repro.models import moe as jax_moe
from repro_torch.configs import get_config
from repro_torch.convert import to_tensor
from repro_torch.models import moe
from repro_torch.models.config import MoESpec

ARCH = "qwen3-moe-235b-a22b"
RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
SHARED = dict(n_shared=2, d_ff_shared=96)


def _cfgs(dtype="float32", kernels=False, shared=False):
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), dtype=dtype,
                               use_pallas=kernels)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype,
                              use_kernels=kernels)
    if shared:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **SHARED))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **SHARED))
    return jcfg, cfg


def _weights(jcfg, seed=0):
    jw = jax_moe.init_moe(jcfg, jax.random.PRNGKey(seed))
    return jw, jax.tree.map(lambda a: to_tensor(np.asarray(a), "cpu"), jw)


def _x(shape, dtype, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, JAX_DT[dtype]), torch.from_numpy(a).to(
        TORCH_DT[dtype])


def _close(port, ref, rtol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_capacity_matches_reference(reduced):
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    for S in (1, 3, 7, 32, 45, 517, 2000):
        assert moe.capacity(cfg, S) == jax_moe.capacity(jcfg, S), S
    if not reduced:   # a paged prefill chunk, sync prefills, a decode step
        assert [moe.capacity(cfg, S) for S in (32, 2000, 517, 1)] == \
            [4, 160, 44, 4]


def test_router_topk_matches_reference():
    jcfg, cfg = _cfgs()
    jw, w = _weights(jcfg)
    jx, x = _x((2, 37, cfg.d_model), "float32", seed=1)
    jg, ji, ja = jax_moe.router_topk(jcfg, jw["router"], jx)
    g, i, a = moe.router_topk(cfg, w["router"], x)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    _close(g, jg, 1e-5)
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-5)
    _close(g.sum(-1), np.ones((2, 37)), 1e-5)


@pytest.mark.parametrize("case", ["zero_input", "duplicate_columns"])
def test_router_topk_breaks_ties_like_reference(case):
    """Tied probabilities pick the lower expert first: all experts tie
    on a zero input; with router columns [a, b, a, b] experts 0/2 and
    1/3 tie on every token."""
    jcfg, cfg = _cfgs()
    jw, w = _weights(jcfg, seed=2)
    router = np.array(jw["router"])
    if case == "zero_input":
        x = np.zeros((2, 9, cfg.d_model), np.float32)
    else:
        router = np.concatenate([router[:, :2], router[:, :2]], axis=1)
        x = np.random.default_rng(3).standard_normal(
            (2, 9, cfg.d_model)).astype(np.float32)
    _, ji, ja = jax_moe.router_topk(jcfg, jnp.asarray(router),
                                    jnp.asarray(x))
    _, i, a = moe.router_topk(cfg, torch.from_numpy(router),
                              torch.from_numpy(x))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    if case == "zero_input":
        assert (i.numpy() == [0, 1]).all()
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-5)


def test_slot_maps_match_reference():
    """A skewed assignment overflows capacity: dropped assignments are
    not kept and occupy no slot (they went to the sink)."""
    jcfg, cfg = _cfgs()
    E, C = cfg.moe.n_experts, 4
    rng = np.random.default_rng(4)
    idx = rng.choice(E, size=(3, 30), p=[0.55, 0.25, 0.15, 0.05]
                     ).astype(np.int32)
    jmaps = jax_moe._slot_maps(jcfg, jnp.asarray(idx), C)
    maps = moe._slot_maps(cfg, torch.from_numpy(idx), C)
    for name, got, want in zip(("pos", "keep", "src", "used"), maps, jmaps):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
    pos, keep, src, used = maps
    assert not bool(keep.all())                        # drops happened
    assert used.shape == (3, E * C)
    assert int(used.sum()) == int(keep.sum())          # sink sliced off
    counts = np.stack([(idx == e).sum(1) for e in range(E)], 1)
    assert (used.numpy().reshape(3, E, C).sum(-1)
            == np.minimum(counts, C)).all()


PATHS = [(d, k, False) for d in RTOL for k in (False, True)] \
    + [("float32", False, True), ("float32", True, True),
       ("bfloat16", True, True)]
# (B, S): a ragged capacity (S 45 >= C 32), decode's one-token groups
# (S 1 < C 4) and two-token groups (S 2 < C 4), whose slot buffers hold
# S rows an expert where the reference's hold C.
SHAPES = [(2, 45), (8, 1), (3, 2)]
CASES = [p + shape for shape in SHAPES for p in PATHS]
IDS = [f"{d}-{'kernels' if k else 'plain'}{'-shared' if s else ''}"
       + ("" if (B, S) == SHAPES[0] else f"-B{B}-S{S}")
       for d, k, s, B, S in CASES]


@pytest.mark.parametrize("dtype,kernels,shared,B,S", CASES, ids=IDS)
def test_moe_apply_matches_reference(dtype, kernels, shared, B, S):
    jcfg, cfg = _cfgs(dtype, kernels, shared)
    jw, w = _weights(jcfg, seed=5)
    if dtype != "float32":
        assert w["we_g"].dtype == TORCH_DT[dtype]
    jx, x = _x((B, S, cfg.d_model), dtype, seed=6)
    C = moe.capacity(cfg, S)
    assert C % 128 and (S >= C) == (S == 45)        # ragged C; S < C
    with kdispatch.decision_scope() as decisions:
        jy, jaux = jax_moe.moe_apply(jcfg, jw, jx)
    dec = decisions.get("moe_gmm")
    if kernels:
        assert dec is not None and dec.use_kernel, dec
    else:
        assert dec is None
    y, aux = moe.moe_apply(cfg, w, x)
    assert y.shape == (B, S, cfg.d_model) and y.dtype == TORCH_DT[dtype]
    _close(y, jy, RTOL[dtype])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def _distinct_topk(rng, G, S, E, K, p):
    """(G, S*K) assignments in token order: each token's K distinct
    experts, drawn without replacement with weights ``p`` (skewed, so
    that a group of S >= C overflows)."""
    return np.stack([np.concatenate([rng.choice(E, K, replace=False, p=p)
                                     for _ in range(S)])
                     for _ in range(G)]).astype(np.int32)


@pytest.mark.parametrize("S", [1, 2, 3, 5, 12, 24])
def test_slot_buffers_hold_what_a_group_can_fill(S, monkeypatch):
    """Distinct top-k experts put each assignment at a position below S
    in its expert, so buffers of min(C, S) rows keep what C rows keep.
    16 experts, top-4 (C 4 while S <= 12, 8 at S 24): the port's maps at
    min(C, S) keep exactly the reference's assignments at C, at the same
    positions and slots; the reference's slots at positions >= S are
    never used; at S >= C the maps are the reference's; and the buffers
    ``moe_apply`` hands ``_expert_mm`` have min(C, S) rows."""
    spec = dict(n_experts=16, top_k=4)
    jcfg, cfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             **spec))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **spec))
    E, K, G = 16, 4, 5
    C = moe.capacity(cfg, S)
    Cb = min(C, S)
    assert C == jax_moe.capacity(jcfg, S) == (8 if S == 24 else 4)
    p = np.full(E, 0.5 / (E - 3))
    p[:3] = [0.3, 0.1, 0.1]
    rng = np.random.default_rng(S)
    idx = _distinct_topk(rng, G, S, E, K, p)
    jpos, jkeep, jsrc, jused = (np.asarray(a) for a in jax_moe._slot_maps(
        jcfg, jnp.asarray(idx), C))
    pos, keep, src, used = (t.numpy() for t in moe._slot_maps(
        cfg, torch.from_numpy(idx), Cb))
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(keep, jkeep)
    assert pos.max() <= S - 1
    jused, jsrc = jused.reshape(G, E, C), jsrc.reshape(G, E, C)
    assert not jused[:, :, S:].any()
    np.testing.assert_array_equal(used.reshape(G, E, Cb), jused[:, :, :Cb])
    np.testing.assert_array_equal(src.reshape(G, E, Cb), jsrc[:, :, :Cb])
    if S >= C:
        assert Cb == C and not keep.all()           # drops happened
    rows = []
    expert_mm = moe._expert_mm
    monkeypatch.setattr(moe, "_expert_mm", lambda x4, w3, **kw: (
        rows.append(x4.shape[2]), expert_mm(x4, w3, **kw))[1])
    w = moe.init_moe(cfg, torch.Generator().manual_seed(S),
                     torch.device("cpu"))
    moe.moe_apply(cfg, w, torch.randn((G, S, cfg.d_model)))
    assert rows == [Cb] * 3


def test_kernel_path_rounds_like_the_reference_kernel_path():
    """In bf16 the kernel path rounds the gate/up products to bf16 and
    the plain path keeps them in f32 (two contracts, as in the
    reference): each port path is nearer its own reference path."""
    jcfg_k, cfg_k = _cfgs("bfloat16", True)
    jcfg_p, cfg_p = _cfgs("bfloat16", False)
    jw, w = _weights(jcfg_k, seed=7)
    jx, x = _x((2, 40, cfg_k.d_model), "bfloat16", seed=8)
    ref_k = np.asarray(jax_moe.moe_apply(jcfg_k, jw, jx)[0], np.float32)
    ref_p = np.asarray(jax_moe.moe_apply(jcfg_p, jw, jx)[0], np.float32)
    got_k = moe.moe_apply(cfg_k, w, x)[0].float().numpy()
    got_p = moe.moe_apply(cfg_p, w, x)[0].float().numpy()
    assert np.abs(got_k - ref_k).sum() < np.abs(got_k - ref_p).sum()
    assert np.abs(got_p - ref_p).sum() < np.abs(got_p - ref_k).sum()


@pytest.mark.parametrize("kernels", [False, True])
def test_padded_rows_never_take_a_valid_tokens_slot(kernels):
    """A right-padded prefill chunk: whatever the rows past n_valid hold,
    the valid rows' outputs are bit-identical, because padded rows come
    later in assignment order and capacity is first-come."""
    _, cfg = _cfgs("float32", kernels)
    _, w = _weights(_cfgs()[0], seed=9)
    C, n_valid = 32, 20
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (1, C, cfg.d_model)).astype(np.float32))
    noise = x.clone()
    noise[:, n_valid:] = 3.0 * torch.from_numpy(
        np.random.default_rng(11).standard_normal(
            (1, C - n_valid, cfg.d_model)).astype(np.float32))
    zero = x.clone()
    zero[:, n_valid:] = 0.0
    y_noise, _ = moe.moe_apply(cfg, w, noise)
    y_zero, _ = moe.moe_apply(cfg, w, zero)
    np.testing.assert_array_equal(y_noise[:, :n_valid].numpy(),
                                  y_zero[:, :n_valid].numpy())


def test_init_moe_shapes_and_types():
    _, cfg = _cfgs("bfloat16", shared=True)
    w = moe.init_moe(cfg, torch.Generator().manual_seed(0),
                     torch.device("cpu"))
    m, D = cfg.moe, cfg.d_model
    assert w["router"].shape == (D, m.n_experts)
    assert w["router"].dtype == torch.float32
    assert w["we_g"].shape == w["we_i"].shape == (m.n_experts, D,
                                                  m.d_ff_expert)
    assert w["we_o"].shape == (m.n_experts, m.d_ff_expert, D)
    assert w["we_o"].dtype == torch.bfloat16
    assert w["shared"]["wg"].shape == (D, m.d_ff_shared)
    assert isinstance(cfg.moe, MoESpec)
