"""The serve API's shared pieces against the reference, on the CPU:
``PagedServeEngine.generate``, ``RunStats.get``/``keys``/``as_dict``,
the ``ServeAPI`` protocol and legacy ``(prompt, n_steps[, arrival])``
tuple traces.  The reduced qwen2-7b in float32, the reference's weights
converted, ``page=128`` on both sides (the port on its kernel path:
the paged kernel's plain version on the CPU).
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serve import PagedServeEngine as JaxPagedServeEngine
from repro.serve.traces import get_trace as jax_get_trace
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.serve import (PagedServeEngine, RunStats, ServeAPI,
                               ServeEngine, get_trace)
from repro_torch.serve import api

JCFG = dataclasses.replace(jax_get_config("qwen2-7b").reduced(),
                           dtype="float32")
CFG = dataclasses.replace(get_config("qwen2-7b").reduced(), dtype="float32")
ENGINE = dict(max_len=128, max_batch=4, page=128)



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread: teacher forcing is many small ops, and
    beside the suite's other workers a pool as wide as the machine makes
    each op wait on threads they hold."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

@pytest.fixture(scope="module")
def weights():
    jparams = jax_init_params(JCFG, jax.random.PRNGKey(0))
    return jparams, convert_params(jax.tree.map(np.asarray, jparams),
                                   device="cpu")


def _trace(n=4, seed=1):
    return (jax_get_trace("base")(n, CFG.vocab_size, seed=seed, max_len=96),
            get_trace("base")(n, CFG.vocab_size, seed=seed, max_len=96))


def test_paged_generate_matches_reference(weights):
    jparams, params = weights
    prompts = np.random.default_rng(0).integers(
        0, CFG.vocab_size, (3, 20)).astype(np.int32)
    want = JaxPagedServeEngine(JCFG, jparams, **ENGINE).generate(
        prompts, n_steps=8)
    got = PagedServeEngine(CFG, params, device="cpu", **ENGINE).generate(
        prompts, n_steps=8)
    assert got.shape == (3, 8) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_run_stats_as_dict_matches_reference(weights):
    jparams, params = weights
    jreqs, reqs = _trace()
    _, jstats = JaxPagedServeEngine(JCFG, jparams, **ENGINE).run(jreqs)
    _, stats = PagedServeEngine(CFG, params, device="cpu", **ENGINE).run(reqs)
    want, got = jstats.as_dict(), stats.as_dict()
    assert list(got) == list(want) == list(stats.keys()) == \
        list(jstats.keys())
    assert got == pytest.approx(want)
    assert stats.get("ticks") == stats["ticks"] == jstats.get("ticks")
    assert stats.get("no such field", -1) == -1
    assert RunStats().as_dict() == dict.fromkeys(got, 0) | {
        k: 0.0 for k in ("prefix_hit_rate", "occupancy_mean",
                         "occupancy_max")}


@pytest.mark.parametrize("engine", ["paged", "sync"])
def test_tuple_trace_matches_requests_and_warns_once(weights, engine):
    _, params = weights
    eng = PagedServeEngine(CFG, params, device="cpu", **ENGINE) \
        if engine == "paged" else ServeEngine(CFG, params, max_len=128,
                                              device="cpu")
    _, reqs = _trace(3, seed=2)
    reqs[2].arrival = 0                     # the 2-tuple's arrival
    tuples = [(r.prompt.tolist(), r.n_steps, r.arrival) for r in reqs[:2]] \
        + [(r.prompt, r.n_steps) for r in reqs[2:]]
    want, wstats = eng.run(reqs)
    api._WARNED.clear()
    with pytest.warns(DeprecationWarning, match="tuples to run"):
        got, gstats = eng.run(tuples)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        again, _ = eng.run(tuples)                      # warned once only
    assert gstats.as_dict() == wstats.as_dict()
    for a, b, c in zip(want, got, again):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, c.tokens)
        assert (a.prompt_len, a.arrival) == (b.prompt_len, b.arrival)
    with pytest.raises(TypeError, match="legacy"):
        eng.run([(reqs[0].prompt,)])


def test_both_engines_meet_the_serve_protocol(weights):
    _, params = weights
    assert isinstance(PagedServeEngine(CFG, params, device="cpu", **ENGINE),
                      ServeAPI)
    assert isinstance(ServeEngine(CFG, params, max_len=128, device="cpu"),
                      ServeAPI)
    assert not isinstance(object(), ServeAPI)
