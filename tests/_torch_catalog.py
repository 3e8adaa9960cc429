"""Shared set-up of the catalog tests (``test_torch_{dense_catalog,mla,
cross,encoder}.py``): the reference's reduced model and the port's twin
with the reference's weights converted, inputs drawn from a seed, and the
tolerance check.

A cross layer's gate starts at zero in both packages, which sends no
cross-attention into the residual: a comparison on such weights would
pass whatever the cross-attention computes.  So every model built here
draws each cross layer's gate from the seed (uniform in [0.25, 0.75]) in
the reference's numpy parameters before both sides take them.  That is a
test input; the reference package itself is unchanged.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import dispatch as kdispatch
from repro.models import init_params as jax_init_params
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import forward as jax_forward
from repro.models.model import prefill as jax_prefill
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import convert_cache, convert_params
from repro_torch.models import decode_step, forward, prefill
from repro_torch.models.layers import DTYPES
from repro_torch.serve import ServeEngine

# forward, prefill and decode_step against the reference: float32 rtol
# 1e-5, bfloat16 rtol 2e-2 (a couple of bf16 ulps), both with an absolute
# floor of rtol times the reference's largest magnitude
RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [(d, k) for d in RTOL for k in (False, True)]
CASE_IDS = [f"{d}-{'kernels' if k else 'plain'}" for d, k in CASES]


def close(port, ref, rtol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(ref).max()))


def xla_cpu_silu(silu):
    """``silu`` as XLA:CPU evaluates ``jax.nn.silu`` on bf16: x *
    logistic(x) with exp(-x), 1 + e, 1 / (1 + e) and the product each
    rounded to bf16 (``torch.nn.functional.silu`` rounds once from f32);
    other types unchanged.  Tests patch it in to show the rest of a bf16
    comparison without that rounding point."""
    def emulated(x):
        if x.dtype != torch.bfloat16:
            return silu(x)
        return x * (1 / (1 + torch.exp(-x)))    # each op rounds to bf16
    return emulated


def nonzero_gates(np_params, seed):
    """Every cross slot's (n_periods,) gate stack drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    for slot in np_params["layers"]:
        if "gate" in slot:
            slot["gate"] = rng.uniform(0.25, 0.75, np.shape(slot["gate"])
                                       ).astype(np.float32)
    return np_params


@functools.lru_cache(maxsize=None)
def models(arch, dtype="float32", kernels=False, seed=0):
    """(reference cfg, reference params, port cfg, port params) of the
    reduced ``arch``: the reference's ``use_pallas`` and the port's
    ``use_kernels`` both ``kernels``; cross gates non-zero."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype,
                               use_pallas=kernels)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                              use_kernels=kernels)
    np_params = nonzero_gates(jax.tree.map(
        np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed))), seed)
    jparams = jax.tree.map(jnp.asarray, np_params)
    return jcfg, jparams, cfg, convert_params(np_params, device="cpu")


def batches(cfg, B, S, seed):
    """The same tokens, and media or frames (normal x 0.5 in cfg.dtype)
    when the model takes them, for the reference and the port."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    for key, rows in (("media", cfg.cross_attn and
                       cfg.cross_attn.n_media_tokens),
                      ("frames", cfg.encoder and cfg.encoder.n_frames)):
        if rows:
            x = (rng.standard_normal((B, rows, cfg.d_model)) * 0.5
                 ).astype(np.float32)
            jb[key] = jnp.asarray(x).astype(cfg.dtype)
            tb[key] = torch.from_numpy(x).to(DTYPES[cfg.dtype])
    return jb, tb


def reference_kernels(decisions, want):
    """The reference's dispatch decisions of one call: each kernel in
    ``want`` (name -> whether it must have run) decided as given, and
    none decided at all on its plain path (``want`` empty)."""
    if not want:
        assert decisions == {}, decisions
    for name, ran in want.items():
        dec = decisions.get(name)
        assert dec is not None and dec.use_kernel == ran, f"{name}: {dec}"


def check_forward(arch, dtype, kernels, want=None, *, B=2, S=21, seed=7):
    """``forward`` in mode train against the reference: logits and aux."""
    jcfg, jparams, cfg, params = models(arch, dtype, kernels)
    jb, tb = batches(cfg, B, S, seed)
    with kdispatch.decision_scope() as decisions:
        jl, jaux = jax_forward(jcfg, jparams, jb, mode="train")
    reference_kernels(decisions, (want or {}) if kernels else {})
    tl, aux = forward(cfg, params, tb, mode="train")
    assert tl.shape == (B, S, cfg.vocab_size) and tl.dtype == torch.float32
    close(tl, jl, RTOL[dtype])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL[dtype],
                               atol=1e-7)


def check_prefill_decode(arch, dtype, kernels, want=None, *, B=2, S=21,
                         max_len=32, seed=8):
    """``prefill`` (logits and every cache leaf), then one
    ``decode_step`` on both sides from the reference's cache carried over
    by ``convert_cache`` (logits and the cache, updated in place)."""
    jcfg, jparams, cfg, params = models(arch, dtype, kernels)
    jb, tb = batches(cfg, B, S, seed)
    rtol = RTOL[dtype]
    with kdispatch.decision_scope() as decisions:
        jl, jcache = jax_prefill(jcfg, jparams, jb, max_len)
    reference_kernels(decisions, (want or {}) if kernels else {})
    tl, cache = prefill(cfg, params, tb, max_len)
    assert tl.shape == (B, 1, cfg.vocab_size)
    close(tl, jl, rtol)
    np_cache = jax.tree.map(np.asarray, jcache)
    want_cache = convert_cache(np_cache, device="cpu")
    assert len(cache) == len(want_cache) == cfg.n_layers
    for got, ref in zip(cache, want_cache):
        assert set(got) == set(ref)
        for n in got:
            assert got[n].shape == ref[n].shape, n
            close(got[n], ref[n].float().numpy(), rtol)
    nxt = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jdl, jnew = jax_decode_step(jcfg, jparams, jcache, jnp.asarray(nxt),
                                jnp.int32(S))
    carried = convert_cache(np_cache, device="cpu")
    tdl, new = decode_step(cfg, params, carried, torch.from_numpy(nxt), S)
    assert new is carried
    close(tdl, jdl, rtol)
    for got, ref in zip(new, convert_cache(jax.tree.map(np.asarray, jnew),
                                           device="cpu")):
        for n in got:
            close(got[n], ref[n].float().numpy(), rtol)


def greedy_streams(arch, n_steps=8, *, B=2, S=13, max_len=24, seed=6):
    """The model-level greedy loop (``prefill``, then ``decode_step``
    fed its own argmax) on both sides in float32, the port on its kernel
    path: (reference tokens, port tokens), each (B, n_steps)."""
    jcfg, jparams, cfg, params = models(arch)
    cfg = dataclasses.replace(cfg, use_kernels=True)
    jb, tb = batches(cfg, B, S, seed)
    jstep = jax.jit(lambda c, t, p: jax_decode_step(jcfg, jparams, c, t, p))
    jl, jc = jax.jit(lambda b: jax_prefill(jcfg, jparams, b, max_len))(jb)
    tl, tc = prefill(cfg, params, tb, max_len)
    jt, tt = [], []
    for i in range(n_steps):
        jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        ttok = tl[:, -1].argmax(-1)[:, None]
        jt.append(np.asarray(jtok))
        tt.append(ttok.numpy())
        jl, jc = jstep(jc, jtok, jnp.int32(S + i))
        tl, tc = decode_step(cfg, params, tc, ttok, S + i)
    return np.concatenate(jt, 1), np.concatenate(tt, 1)


def engine_streams(arch, n_steps=8, *, B=2, S=13, max_len=24, seed=6):
    """``ServeEngine.generate(extras=...)`` on both sides in float32, the
    media or frames passed as extras, the port on its kernel path:
    (reference tokens, port tokens), each (B, n_steps)."""
    jcfg, jparams, cfg, params = models(arch)
    cfg = dataclasses.replace(cfg, use_kernels=True)
    jb, tb = batches(cfg, B, S, seed)
    toks = np.asarray(jb.pop("tokens"))
    tb.pop("tokens")
    ref = JaxServeEngine(jcfg, jparams, max_len=max_len).generate(
        toks, n_steps=n_steps, extras=jb)
    got = ServeEngine(cfg, params, max_len=max_len, device="cpu").generate(
        toks, n_steps=n_steps, extras=tb)
    return ref.tokens, got.tokens
