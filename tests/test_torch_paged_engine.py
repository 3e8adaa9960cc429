"""The port's PagedServeEngine against the reference's, on the CPU.

Both engines serve the same traces (drawn by the reference's trace
generators; the port's copies must draw the same requests) with the
reduced qwen2-7b (bfloat16, and float32 on the default trace), the
reference's weights converted, and ``page=128`` on both sides.  The reference runs ``use_pallas=False``;
the port runs its default ``use_kernels=True`` (the paged kernel's
plain version on the CPU).

Required: identical statuses, per-request admission and finish ticks,
run counters (ticks, decode steps, prefill chunks, preemptions, shed,
timeouts, prefix hits), and identical greedy tokens up to the near-tie
rule of ``repro_torch.serve.parity``: a stream may first differ only
where float32 (the port's plain path in float32, teacher-forced along
the common prefix) picks the port's token or lies within its tau of it;
the reference margin is recomputed on the port's plain path
(``use_kernels=False``).  In float32 the streams must be identical
outright.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serve import DeadlineAwareShed as JaxDeadlineAwareShed
from repro.serve import Fault as JaxFault
from repro.serve import FaultPlan as JaxFaultPlan
from repro.serve import PagedServeEngine as JaxPagedServeEngine
from repro.serve import Request as JaxRequest
from repro.serve.traces import get_trace as jax_get_trace
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.serve import (OK, DeadlineAwareShed, Fault, FaultPlan,
                               PagedServeEngine, get_trace)
from repro_torch.serve.parity import describe, divergences

JCFG = jax_get_config("qwen2-7b").reduced()
CFG = get_config("qwen2-7b").reduced()
JPARAMS = jax_init_params(JCFG, jax.random.PRNGKey(0))
PARAMS = convert_params(jax.tree.map(np.asarray, JPARAMS), device="cpu")
PAGE = 128


@functools.lru_cache(maxsize=None)
def _models(dtype):
    """(reference cfg, reference params, port cfg, port params)."""
    if dtype == CFG.dtype:
        return JCFG, JPARAMS, CFG, PARAMS
    jcfg = dataclasses.replace(JCFG, dtype=dtype)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return (jcfg, jparams, dataclasses.replace(CFG, dtype=dtype),
            convert_params(jax.tree.map(np.asarray, jparams), device="cpu"))


_COUNTERS = ("requests", "tokens", "ticks", "decode_steps", "prefill_chunks",
             "prefix_blocks_reused", "prefix_blocks_needed", "completed",
             "shed", "timeouts", "cancelled", "preemptions", "stalled_ticks")

# name: (trace, trace kwargs, engine kwargs, whether faults are injected)
CASES = {
    "default": ("base", dict(max_len=128), dict(max_len=128, max_batch=4),
                False),
    "default_f32": ("base", dict(max_len=128, dtype="float32"),
                    dict(max_len=128, max_batch=4), False),
    "shared": ("shared_prefix", dict(prefix_len=128),
               dict(max_len=256, max_batch=4), False),
    "overload": ("overload", dict(max_len=256, seed=3),
                 dict(max_len=256, max_batch=2, n_blocks=3, max_queue=4,
                      shed_slack=2), False),
    "overload_faults": ("overload", dict(max_len=160, seed=3, n=10),
                        dict(max_len=160, max_batch=2, prefix_cache=False,
                             max_queue=4, shed_slack=2), True),
}


def _plan(fault_cls, plan_cls):
    return plan_cls(faults=[fault_cls("exhaust", tick=4, n=2, duration=3),
                            fault_cls("preempt", tick=8, n=1),
                            fault_cls("stall", tick=11, duration=2)])


def _serve(name):
    trace, tkw, ekw, faults = CASES[name]
    tkw = dict(tkw)
    n = tkw.pop("n", 8)
    seed = tkw.pop("seed", 0)
    jcfg, jparams, cfg, params = _models(tkw.pop("dtype", "bfloat16"))
    ekw = dict(ekw, page=PAGE)
    slack = ekw.pop("shed_slack", None)
    jreqs = jax_get_trace(trace)(n, CFG.vocab_size, seed=seed, **tkw)
    reqs = get_trace(trace)(n, CFG.vocab_size, seed=seed, **tkw)
    jeng = JaxPagedServeEngine(
        jcfg, jparams, admission=None if slack is None
        else JaxDeadlineAwareShed(slack), **ekw)
    eng = PagedServeEngine(
        cfg, params, device="cpu", admission=None if slack is None
        else DeadlineAwareShed(slack), **ekw)
    jres, jstats = jeng.run(
        jreqs, max_ticks=5000,
        fault_plan=_plan(JaxFault, JaxFaultPlan) if faults else None)
    res, stats = eng.run(
        reqs, max_ticks=5000,
        fault_plan=_plan(Fault, FaultPlan) if faults else None)
    return jreqs, reqs, (jres, jstats), (res, stats), eng


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_reference(name):
    jreqs, reqs, (jres, jstats), (res, stats), eng = _serve(name)
    for a, b in zip(jreqs, reqs):
        assert isinstance(a, JaxRequest)
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.n_steps, a.arrival, a.deadline) == \
            (b.n_steps, b.arrival, b.deadline)
    for f in _COUNTERS:
        assert stats[f] == jstats[f], f
    assert stats.prefix_hit_rate == pytest.approx(jstats.prefix_hit_rate)
    for i, (a, b) in enumerate(zip(jres, res)):
        assert (b.status, b.admitted, b.finished, b.prefix_blocks,
                b.preemptions, len(b.tokens)) == \
            (a.status, a.admitted, a.finished, a.prefix_blocks,
             a.preemptions, len(a.tokens)), f"request {i}"
    plain = PagedServeEngine(dataclasses.replace(eng.cfg, use_kernels=False),
                             eng.params, max_len=eng.max_len, page=PAGE,
                             device="cpu")
    div = divergences(plain, reqs, jres, res)
    bad = [describe(d) for d in div if not d["accepted"]]
    assert not bad, bad
    if eng.cfg.dtype == "float32":
        assert not div, f"float32 greedy streams differ: {div}"
    assert eng.cache.free_blocks == eng.cache.capacity


def test_traces_exercise_each_path():
    """The cases above reach prefix hits, shedding, preemption and
    timeouts, so the parity checks cover those scheduler paths."""
    _, _, _, (_, shared), _ = _serve("shared")
    assert shared.prefix_hit_rate > 0
    _, _, _, (res, over), _ = _serve("overload")
    assert over.preemptions > 0 and over.shed > 0
    assert any(r.status == OK for r in res)
    _, _, _, (_, faults), _ = _serve("overload_faults")
    assert faults.timeouts + faults.shed > 0 and faults.stalled_ticks > 0


def test_run_is_deterministic_across_reuse():
    """A second run on the dirty pool gives the first run's tokens."""
    reqs = get_trace("base")(4, CFG.vocab_size, seed=5)
    eng = PagedServeEngine(CFG, PARAMS, max_len=128, max_batch=2,
                           n_blocks=3, page=PAGE, device="cpu")
    first, _ = eng.run(reqs)
    second, _ = eng.run(reqs)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_temperature_sampling_is_seeded():
    reqs = get_trace("base")(3, CFG.vocab_size, seed=6)
    eng = PagedServeEngine(CFG, PARAMS, max_len=128, max_batch=4,
                           page=PAGE, device="cpu")
    a, _ = eng.run(reqs, temperature=1.0, seed=0)
    b, _ = eng.run(reqs, temperature=1.0, seed=0)
    c, _ = eng.run(reqs, temperature=1.0, seed=1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)
    assert any(not np.array_equal(x.tokens, z.tokens) for x, z in zip(a, c))


def test_oversized_request_fails_fast():
    reqs = get_trace("base")(1, CFG.vocab_size, seed=7)
    eng = PagedServeEngine(CFG, PARAMS, max_len=128, max_batch=1, page=64,
                           n_blocks=2, device="cpu")
    reqs[0].n_steps = 128 - reqs[0].prompt.shape[0]
    with pytest.raises(ValueError, match="n_blocks >="):
        eng.run(reqs)


def test_params_on_another_device_raise():
    with pytest.raises(ValueError, match="params live on"):
        PagedServeEngine(CFG, {"embed": PARAMS["embed"].to("meta")},
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
def test_moe_engine_matches_reference(dtype):
    """The MoE model through the paged engine on the shared-prefix trace
    (32-row prefill chunks, so chunk capacity drops are the reference's
    too): identical statuses, per-request ticks and run counters; float32
    streams identical, bfloat16 streams under the near-tie rule, routing
    roots included."""
    jcfg, jparams, cfg, params = _moe_models(dtype)
    kw = dict(max_len=256, max_batch=4, page=PAGE)
    jreqs = jax_get_trace("shared_prefix")(6, CFG.vocab_size, seed=1,
                                           prefix_len=128)
    reqs = get_trace("shared_prefix")(6, CFG.vocab_size, seed=1,
                                      prefix_len=128)
    jres, jstats = JaxPagedServeEngine(jcfg, jparams, **kw).run(jreqs)
    eng = PagedServeEngine(cfg, params, device="cpu", **kw)
    res, stats = eng.run(reqs)
    for f in _COUNTERS:
        assert stats[f] == jstats[f], f
    assert stats.prefix_hit_rate > 0
    for i, (a, b) in enumerate(zip(jres, res)):
        assert (b.status, b.admitted, b.finished, b.prefix_blocks,
                len(b.tokens)) == (a.status, a.admitted, a.finished,
                                   a.prefix_blocks, len(a.tokens)), i
        assert b.status == OK
    plain = PagedServeEngine(dataclasses.replace(cfg, use_kernels=False),
                             params, max_len=256, page=PAGE, device="cpu")
    div = divergences(plain, reqs, jres, res, engine=eng)
    bad = [describe(d) for d in div if not d["accepted"]]
    assert not bad, bad
    if dtype == "float32":
        assert not div, f"float32 greedy streams differ: {div}"
