"""Layer primitives and the parameter converter against the reference.

Inputs are drawn with numpy from a fixed seed and handed to both
packages; weights come from the reference's own initialisers through
``repro_torch.convert``.  Tolerances: float32 rtol 1e-5 (the two
frameworks sum in different orders), bfloat16 rtol 2e-2 (a couple of
bf16 ulps, which have 8 bits of mantissa); both with an absolute floor
of rtol times the reference's largest magnitude, for entries near 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import blocks as jblocks
from repro.models import init_params as jax_init_params
from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.convert import convert_params, to_tensor
from repro_torch.models import layers as tl

RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = list(RTOL)


def _cfgs(dtype, **kw):
    return (dataclasses.replace(jax_get_config("qwen2-7b").reduced(),
                                dtype=dtype, **kw),
            dataclasses.replace(get_config("qwen2-7b").reduced(),
                                dtype=dtype, **kw))


def _pair(x, dtype):
    """One numpy array as a reference array and a port tensor of dtype."""
    return (jnp.asarray(x, jl.DTYPES[dtype]),
            torch.from_numpy(np.asarray(x)).to(tl.DTYPES[dtype]))


def _close(port, ref, dtype):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    port = port.float().numpy()
    assert port.shape == ref.shape
    rtol = RTOL[dtype]
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(ref).max()))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_port(tree):
    return jax.tree.map(lambda a: to_tensor(np.asarray(a), "cpu"), tree)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_and_mm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32) / 8
    b = rng.standard_normal((48,)).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in (x, w, b))
    _close(tl.dense(tx, tw, tb), jl.dense(jx, jw, jb), dtype)
    _close(tl.mm(tx, tw), jl.mm("...k,kn->...n", jx, jw), dtype)


@pytest.mark.parametrize("norm_type", ["rms", "layer"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_norm(dtype, norm_type):
    jcfg, cfg = _cfgs(dtype, norm_type=norm_type)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 128)).astype(np.float32) * 3
    jx, tx = _pair(x, dtype)
    if norm_type == "rms":
        s = rng.standard_normal(128).astype(np.float32)
        jw, tw = _pair(s, dtype)
    else:
        s, bias = (rng.standard_normal(128).astype(np.float32)
                   for _ in range(2))
        (js, ts), (jb, tb) = _pair(s, dtype), _pair(bias, dtype)
        jw, tw = {"scale": js, "bias": jb}, {"scale": ts, "bias": tb}
    _close(tl.norm_apply(cfg, tw, tx), jl.norm_apply(jcfg, jw, jx), dtype)


@pytest.mark.parametrize("batched", [False, True], ids=["seq", "batch_seq"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rope(dtype, batched):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 6, 4, 32)).astype(np.float32)
    pos = (rng.integers(0, 4000, (3, 6)) if batched
           else np.arange(6) + 17).astype(np.int32)
    jx, tx = _pair(x, dtype)
    _close(tl.rope(tx, torch.from_numpy(pos), 1e6),
           jl.rope(jx, jnp.asarray(pos), 1e6), dtype)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp(dtype, mlp_type):
    jcfg, cfg = _cfgs(dtype, mlp_type=mlp_type)
    jw = jblocks.init_mlp(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    _close(tl.mlp_apply(cfg, _to_port(jw), tx), jl.mlp_apply(jcfg, jw, jx),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_and_unembed(dtype):
    jcfg, cfg = _cfgs(dtype)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(4))
    tp = convert_params(_np_tree(jp), device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    je = jl.embed_apply(jcfg, jp["embed"], jnp.asarray(toks))
    te = tl.embed_apply(cfg, tp["embed"], torch.from_numpy(toks).long())
    _close(te, je, dtype)
    _close(tl.unembed_apply(cfg, tp["unembed"], te),
           jl.unembed_apply(jcfg, jp["unembed"], je), dtype)


def test_convert_unstacks_layers0_and_period_stacks():
    """first_k_dense=1 gives a ``layers0`` list plus one stacked period
    slot: the port's list must hold every layer in global order."""
    jcfg = dataclasses.replace(jax_get_config("qwen2-7b").reduced(),
                               first_k_dense=1)
    first_k, period, n_periods = jblocks.schedule(jcfg)
    assert (first_k, period, n_periods) == (1, 1, 3)
    jp = _np_tree(jax_init_params(jcfg, jax.random.PRNGKey(5)))
    tp = convert_params(jp, device="cpu")
    assert len(tp["layers"]) == jcfg.n_layers
    want = [jp["layers0"][0]["mixer"]["wq"]] + [
        jp["layers"][0]["mixer"]["wq"][p] for p in range(n_periods)]
    for got, ref in zip(tp["layers"], want):
        assert got["mixer"]["wq"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["mixer"]["wq"].float().numpy(),
                                      np.asarray(ref, np.float32))
    assert set(tp) == {"embed", "final_norm", "unembed", "layers"}


def test_convert_bf16_is_bit_exact():
    x = np.asarray(jnp.asarray(np.linspace(-3, 3, 37), jnp.bfloat16))
    t = to_tensor(x, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  x.view(np.int16))
