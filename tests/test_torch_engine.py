"""The port's sync ServeEngine against the reference's, on the CPU.

Both engines serve the same requests of the ``base`` trace (the port's
copy of the generator must draw the same prompts) for 16 greedy tokens
each, with the reduced qwen2-7b and the reference's weights converted.
The reference runs ``use_pallas=False``; the port runs its default
``use_kernels=True``, so every prefill goes through ``flash_attention``
and every decode step through ``decode_attention`` (their plain versions
on the CPU).

Required: ``run(batch=1)`` streams identical in float32; in bfloat16 a
stream may first differ from the reference's only where the rule of
``repro_torch.serve.parity`` accepts it: float32 (the port's plain path
in float32, teacher-forced along the common prefix) picks the port's
token or lies within its tau of it, or, on an MoE model, the first
routing difference is one float32 takes too or a float32 near-tie.
The reference margin is recomputed on the port's plain path
(``use_kernels=False``) and printed in the records.  One ``batch=2``
case pins the convoy semantics (prompts right-padded to the group
maximum, logits taken at the padded last position): identical streams
in float32.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.traces import get_trace as jax_get_trace
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.kernels import launch_counts
from repro_torch.serve import ServeEngine, get_trace
from repro_torch.serve.parity import describe, divergences

MAX_LEN, N_STEPS = 128, 16


@functools.lru_cache(maxsize=None)
def _models(dtype):
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = dataclasses.replace(jax_get_config("qwen2-7b").reduced(),
                               dtype=dtype)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(), dtype=dtype)
    return jcfg, jparams, cfg, convert_params(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _traces(n, seed):
    vocab = get_config("qwen2-7b").reduced().vocab_size
    jreqs = jax_get_trace("base")(n, vocab, seed=seed, max_len=MAX_LEN)
    reqs = get_trace("base")(n, vocab, seed=seed, max_len=MAX_LEN)
    for a, b in zip(jreqs, reqs):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        a.n_steps = b.n_steps = N_STEPS
        assert a.prompt.shape[0] + N_STEPS <= MAX_LEN
    return jreqs, reqs


def _serve(dtype, batch, n=4, seed=2):
    jcfg, jparams, cfg, params = _models(dtype)
    jreqs, reqs = _traces(n, seed)
    jres, jstats = JaxServeEngine(jcfg, jparams, max_len=MAX_LEN).run(
        jreqs, batch=batch)
    eng = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    res, stats = eng.run(reqs, batch=batch)
    for f in ("requests", "tokens", "decode_steps", "batches"):
        assert stats[f] == jstats[f], f
    for a, b in zip(jres, res):
        assert (b.prompt_len, b.admitted, b.finished, len(b.tokens)) == \
            (a.prompt_len, a.admitted, a.finished, len(a.tokens))
    return reqs, jres, res, eng


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_oracle_matches_reference(dtype):
    reqs, jres, res, eng = _serve(dtype, batch=1)
    plain = ServeEngine(dataclasses.replace(eng.cfg, use_kernels=False),
                        eng.params, max_len=MAX_LEN, device="cpu")
    div = divergences(plain, reqs, jres, res)
    bad = [describe(d) for d in div if not d["accepted"]]
    assert not bad, bad
    if dtype == "float32":
        assert not div, f"float32 greedy streams differ: {div}"


def test_convoy_batch_matches_reference():
    """batch=2 keeps the reference's convoy semantics exactly."""
    reqs, jres, res, _ = _serve("float32", batch=2, n=3, seed=3)
    assert len({r.prompt.shape[0] for r in reqs[:2]}) == 2   # padding runs
    for a, b in zip(jres, res):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_run_batch1_equals_generate():
    _, _, cfg, params = _models("float32")
    _, reqs = _traces(2, seed=4)
    eng = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    res, _ = eng.run(reqs)
    for r, got in zip(reqs, res):
        solo = eng.generate(r.prompt[None], n_steps=r.n_steps).tokens[0]
        np.testing.assert_array_equal(solo, got.tokens)


def test_prefill_pad_keeps_the_stream():
    _, _, cfg, params = _models("float32")
    _, reqs = _traces(1, seed=5)
    p = reqs[0].prompt[None]
    a = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    b = ServeEngine(cfg, params, max_len=MAX_LEN, prefill_pad=True,
                    device="cpu")
    np.testing.assert_array_equal(a.generate(p, n_steps=8).tokens,
                                  b.generate(p, n_steps=8).tokens)


def test_bucket_overflow_raises_value_error():
    _, _, cfg, params = _models("float32")
    eng = ServeEngine(cfg, params, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="max_len bucket of 32"):
        eng.generate(np.zeros((1, 20), np.int32), n_steps=13)
    with pytest.raises(ValueError, match="batch=0"):
        eng.run([], batch=0)


def test_temperature_sampling_is_seeded():
    _, _, cfg, params = _models("float32")
    eng = ServeEngine(cfg, params, max_len=64, device="cpu")
    p = np.arange(24, dtype=np.int32).reshape(2, 12)
    a = eng.generate(p, n_steps=8, temperature=1.0, seed=0).tokens
    b = eng.generate(p, n_steps=8, temperature=1.0, seed=0).tokens
    c = eng.generate(p, n_steps=8, temperature=1.0, seed=1).tokens
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_params_on_another_device_raise():
    _, _, cfg, params = _models("float32")
    with pytest.raises(ValueError, match="params live on"):
        ServeEngine(cfg, {"embed": params["embed"].to("meta")},
                    device="cpu")


# -- MoE: the reduced qwen3-moe-235b-a22b (4 experts, top-2) ----------------

MOE = "qwen3-moe-235b-a22b"


@functools.lru_cache(maxsize=None)
def _moe_models(dtype):
    jcfg = dataclasses.replace(jax_get_config(MOE).reduced(), dtype=dtype)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    cfg = dataclasses.replace(get_config(MOE).reduced(), dtype=dtype)
    return jcfg, jparams, cfg, convert_params(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_greedy_oracle_matches_reference(dtype):
    """The MoE model through the sync engine on the kernel path (the
    moe_gmm and attention kernels' plain versions on the CPU): equal
    statistics and per-request timing; float32 streams identical,
    bfloat16 streams under the near-tie rule, routing roots included."""
    jcfg, jparams, cfg, params = _moe_models(dtype)
    jreqs, reqs = _traces(4, seed=6)
    jres, jstats = JaxServeEngine(jcfg, jparams, max_len=MAX_LEN).run(jreqs)
    eng = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    res, stats = eng.run(reqs)
    for f in ("requests", "tokens", "decode_steps", "batches"):
        assert stats[f] == jstats[f], f
    for a, b in zip(jres, res):
        assert (b.prompt_len, b.admitted, b.finished, len(b.tokens)) == \
            (a.prompt_len, a.admitted, a.finished, len(a.tokens))
    plain = ServeEngine(dataclasses.replace(cfg, use_kernels=False), params,
                        max_len=MAX_LEN, device="cpu")
    div = divergences(plain, reqs, jres, res, engine=eng)
    bad = [describe(d) for d in div if not d["accepted"]]
    assert not bad, bad
    if dtype == "float32":
        assert not div, f"float32 greedy streams differ: {div}"


# -- SSM and hybrid: the reduced mamba2-370m and jamba-v0.1-52b --------------
#
# The reference serves these only through its sync engine, as the port
# does.  Kernel path as above: every prefill runs mamba2_ssd twice per
# SSM layer (its plain version on the CPU).  In a right-padded group
# (``batch=2`` with prompts of different lengths) the padding tokens run
# through the SSM state and conv window of the shorter prompt, where
# attention masks them; the reference does the same, and the port copies
# it.
#
# jamba runs in float32 only here, as in tests/test_torch_model.py.  In
# bfloat16 two requests of this trace part from the reference's streams
# at step 11, at top-2 margins of 0.061 and 0.051, above the margin-only
# rule's 0.05 that held these streams until the float32-arbitrated rule,
# with the port's plain path as with its kernel path.  The prefill differs
# only through the dense SwiGLU's SiLU, which XLA:CPU rounds at more
# points than the port (test_jamba_bf16_layers_match_reference_but_for_
# silu in tests/test_torch_model.py; with that SiLU emulated the bf16
# prefill is bit for bit the reference's through all 8 layers); decode
# then parts through the SSM state's f32 sums taken in other orders.  The
# card holds its bf16 streams to the port's plain path (chip_smoke.py).

SSM_ARCHS = {"mamba2": ("mamba2-370m", 2), "jamba": ("jamba-v0.1-52b", 3)}


@functools.lru_cache(maxsize=None)
def _ssm_models(name, dtype):
    arch, seed = SSM_ARCHS[name]
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    return jcfg, jparams, cfg, convert_params(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _ssm_serve(name, dtype, batch, n, seed):
    jcfg, jparams, cfg, params = _ssm_models(name, dtype)
    jreqs, reqs = _traces(n, seed)
    jres, jstats = JaxServeEngine(jcfg, jparams, max_len=MAX_LEN).run(
        jreqs, batch=batch)
    eng = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    before = launch_counts()["mamba2_ssd"]
    res, stats = eng.run(reqs, batch=batch)
    n_ssm = sum(cfg.layer_kind(i) == "ssm" for i in range(cfg.n_layers))
    assert launch_counts()["mamba2_ssd"] == before     # CPU: plain runs
    assert n_ssm > 0
    for f in ("requests", "tokens", "decode_steps", "batches"):
        assert stats[f] == jstats[f], f
    for a, b in zip(jres, res):
        assert (b.prompt_len, b.admitted, b.finished, len(b.tokens)) == \
            (a.prompt_len, a.admitted, a.finished, len(a.tokens))
    return reqs, jres, res, eng


@pytest.mark.parametrize("name,dtype", [("mamba2", "float32"),
                                        ("mamba2", "bfloat16"),
                                        ("jamba", "float32")])
def test_ssm_greedy_oracle_matches_reference(name, dtype):
    reqs, jres, res, eng = _ssm_serve(name, dtype, batch=1, n=4, seed=7)
    plain = ServeEngine(dataclasses.replace(eng.cfg, use_kernels=False),
                        eng.params, max_len=MAX_LEN, device="cpu")
    div = divergences(plain, reqs, jres, res)
    bad = [describe(d) for d in div if not d["accepted"]]
    assert not bad, bad
    if dtype == "float32":
        assert not div, f"float32 greedy streams differ: {div}"


@pytest.mark.parametrize("name", list(SSM_ARCHS))
def test_ssm_convoy_batch_matches_reference(name):
    """batch=2 over prompts of different lengths: the shorter prompt's
    padding runs through its SSM state, in the reference and the port
    alike, and the float32 streams are identical."""
    reqs, jres, res, _ = _ssm_serve(name, "float32", batch=2, n=3, seed=3)
    assert len({r.prompt.shape[0] for r in reqs[:2]}) == 2
    for a, b in zip(jres, res):
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("name", list(SSM_ARCHS))
def test_ssm_generate_and_prefill_pad(name):
    """``run(batch=1)`` equals ``generate`` request by request, and
    ``teacher_forced_logits`` along a stream picks its tokens; with
    ``prefill_pad`` the padding runs through the SSM state, so the
    stream is the reference's ``prefill_pad`` stream."""
    jcfg, jparams, cfg, params = _ssm_models(name, "float32")
    jreqs, reqs = _traces(2, seed=4)
    eng = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    res, _ = eng.run(reqs)
    for r, got in zip(reqs, res):
        solo = eng.generate(r.prompt[None], n_steps=r.n_steps).tokens[0]
        np.testing.assert_array_equal(solo, got.tokens)
        logits = eng.teacher_forced_logits(r.prompt, got.tokens)
        assert [int(l.argmax()) for l in logits] == list(got.tokens)
    p = reqs[0].prompt[None]
    padded = ServeEngine(cfg, params, max_len=MAX_LEN, prefill_pad=True,
                         device="cpu").generate(p, n_steps=8).tokens
    want = JaxServeEngine(jcfg, jparams, max_len=MAX_LEN,
                          prefill_pad=True).generate(p, n_steps=8).tokens
    np.testing.assert_array_equal(padded, np.asarray(want))
