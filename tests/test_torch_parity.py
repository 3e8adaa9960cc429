"""The exactly arbitrated near-tie rule of ``repro_torch.serve.parity``
on the CPU.

* Stub engines, whose teacher-forced logits and router probabilities
  are written by hand, show the rule's verdicts: it refuses a divergence
  the old margin-only rule (reference top-2 margin < 0.05) accepted,
  where the exact run prefers the reference token by more than tau; it
  accepts one the old rule refused, where the exact run picks the tested
  token at a reference margin above 0.05; and it judges a routing root
  each way (the tested top-k set is the exact run's; the exact run is
  itself at a near-tie; neither).
* tau is read from ``parity.READINGS``, the calibration's readings, by
  working type: a float32 model is judged by a float64 run at the
  float32 readings (a gap bf16's tau accepts is refused), and a routing
  tau that could refuse nothing raises.  The calibration's own
  measurement on the reduced dense model lands on its reading.
* The float64 run leaves no float32 arithmetic; ``routing_log(follow=)``
  routes a run as another's log.
* ``routing_differences`` on hand-made router probabilities,
  ``routing_log`` on the reduced qwen3-moe (one call per MoE layer,
  nothing changed), the layer-at-a-time float32 weights, and
  ``divergences(engine=...)`` on the reduced MoE model served by the
  paged engine on its kernel path (the kernels' plain versions on the
  CPU) against its plain path in bfloat16, where the two paths round
  differently and the routing rule decides some divergences.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs import get_config
from repro_torch.models import forward, init_params
from repro_torch.models import moe as moe_module
from repro_torch.serve import (PagedServeEngine, RequestResult, ServeEngine,
                               get_trace)
from repro_torch.serve import parity
from repro_torch.serve.api import Request
from repro_torch.serve.parity import (divergences, float32_params,
                                      routing_differences, routing_log,
                                      tau_route, taus)

CFG = get_config("qwen3-moe-235b-a22b").reduced()
DENSE = get_config("qwen2-7b").reduced()
DENSE32 = dataclasses.replace(DENSE, dtype="float32")
# the calibration seed offset whose reduced dense reading is the largest
CALIBRATION_SEED = 2000
OLD_NEAR_TIE = 0.05              # the margin-only rule this one replaced
SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread: teacher forcing is many small ops, and
    beside the suite's other workers a pool as wide as the machine makes
    each op wait on threads they hold."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

def _result(tokens):
    return RequestResult(tokens=np.asarray(tokens, np.int32), prompt_len=3,
                         arrival=0, admitted=0, finished=0, emit_times=[])


class Stub:
    """Teacher forcing from fixed logits: ``logits[i]`` behind token i,
    and, per call, one MoE router call per entry of ``probs`` (logged by
    ``routing_log`` through ``moe.router_topk``)."""

    def __init__(self, cfg, logits, probs=()):
        self.cfg, self.logits, self.probs = cfg, logits, probs

    def teacher_forced_logits(self, prompt, tokens):
        for p in self.probs:
            p = torch.tensor(p, dtype=torch.float32)
            moe_module.router_topk(self.cfg, torch.eye(p.shape[-1]),
                                   torch.log(p / p.sum())[None, None])
        return [torch.tensor(self.logits[i], dtype=torch.float32)
                for i in range(len(tokens))]


def _judge(cfg, ref_logits, exact_logits, *, probs=None, engine_probs=None):
    """The reference's stream [0, 1] against the tested [0, 2]: the
    records ``divergences`` gives with stub engines (``exact_logits``
    and ``probs["exact"]``: the exact run's)."""
    first = [3.0, 0.0, 0.0, 0.0]
    ref = Stub(cfg, [first, ref_logits], probs["ref"] if probs else ())
    exact = Stub(cfg, [first, exact_logits], probs["exact"] if probs else ())
    engine = None if engine_probs is None else Stub(
        cfg, [first, ref_logits], engine_probs)
    return divergences(ref, [Request(np.zeros(3, np.int32), 2)],
                       [_result([0, 1])], [_result([0, 2])], engine=engine,
                       exact=exact)


def test_refuses_what_the_margin_rule_took():
    """Reference margin 0.03 (< 0.05: the old rule accepted); float32
    prefers the reference token by tau + 0.05."""
    tau, _ = taus(DENSE)
    (d,) = _judge(DENSE, [0.0, 1.0, 0.97, 0.0],
                  [0.0, 1.0, 1.0 - tau - 0.05, 0.0])
    assert d["margin"] == pytest.approx(0.03) and d["margin"] < OLD_NEAR_TIE
    assert (d["step"], d["token"], d["ref_token"], d["exact_token"]) == \
        (1, 2, 1, 1)
    assert d["exact_gap"] == pytest.approx(tau + 0.05)
    assert not d["accepted"]
    assert parity.describe(d).endswith(": REFUSED")


def test_accepts_what_the_margin_rule_refused():
    """Reference margin 0.2 (>= 0.05: the old rule refused); float32
    picks the tested token, or sits within tau of it."""
    tau, _ = taus(DENSE)
    (d,) = _judge(DENSE, [0.0, 1.0, 0.8, 0.0], [0.0, 1.0, 1.1, 0.0])
    assert d["margin"] == pytest.approx(0.2) and d["margin"] > OLD_NEAR_TIE
    assert d["exact_token"] == 2 and d["exact_gap"] == 0.0 and d["accepted"]
    (d,) = _judge(DENSE, [0.0, 1.0, 0.8, 0.0],
                  [0.0, 1.0, 1.0 - tau / 2, 0.0])
    assert d["exact_token"] == 1 and d["accepted"]          # a float32 tie
    assert parity.describe(d).endswith(": accepted")


def test_streams_of_other_lengths_and_equal_streams():
    ref = Stub(DENSE, [[1.0, 0.0]] * 3)
    req = [Request(np.zeros(3, np.int32), 2)]
    assert divergences(ref, req, [_result([0, 1])], [_result([0, 1])],
                       exact=ref) == []
    (d,) = divergences(ref, req, [_result([0, 1])], [_result([0])],
                       exact=ref)
    assert d["step"] is None and not d["accepted"]


# the stream rule refuses each of these (float32 prefers the reference
# token by 1.0); the routing root decides.  Reference top-2 {0, 1},
# tested {0, 2}; float32 as given.  tau_route fixed at 0.02 here.
ROUTE_CASES = {
    "tested as float32": ([0.4, 0.2, 0.3, 0.1], True, True),
    "float32 near-tie": ([0.4, 0.255, 0.245, 0.1], False, True),
    "unlike float32 above tau": ([0.4, 0.3, 0.2, 0.1], False, False),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_routing_root_is_judged_by_float32(case, monkeypatch):
    monkeypatch.setitem(parity.READINGS["bfloat16"], "reduced",
                        {"all": (0.05, 0.01)})
    f32, as_exact, accepted = ROUTE_CASES[case]
    ref_p, got_p = [0.4, 0.3, 0.2, 0.1], [0.4, 0.2, 0.3, 0.1]
    (d,) = _judge(CFG, [0.0, 1.0, 0.5, 0.0], [0.0, 1.0, 0.0, 0.0],
                  probs={"ref": [ref_p, ref_p], "exact": [ref_p, f32]},
                  engine_probs=[ref_p, got_p])
    assert d["exact_token"] == 1 and d["exact_gap"] == pytest.approx(1.0)
    r = d["routing"]
    assert r["call"] == 1 and r["tau"] == pytest.approx(0.02)
    assert set(r["rows"]) == {0}
    row = r["rows"][0]
    assert row["ref_margin"] == pytest.approx(0.1)
    assert row["exact_margin"] == pytest.approx(
        sorted(f32)[-2] - sorted(f32)[-3], abs=1e-6)
    assert row["as_exact"] is as_exact
    assert d["accepted"] is accepted
    assert "routing root at MoE call 1" in parity.describe(d)


def test_tau_is_read_from_the_calibration_readings(monkeypatch):
    """taus() is twice READINGS at the config's working type, scale and
    family, the records carry it, and a changed reading changes the
    verdict."""
    for cfg, scale in ((DENSE, "reduced"), (CFG, "reduced"),
                       (DENSE32, "reduced"),
                       (get_config("qwen2-7b"), "full"),
                       (get_config("deepseek-v2-lite-16b"), "full"),
                       (get_config("jamba-v0.1-52b").reduced(), "reduced")):
        entries = parity.READINGS[cfg.dtype][scale]
        logit, route = entries.get(parity.family(cfg), entries.get("all"))
        want = (2 * logit, None if route is None else 2 * route)
        assert taus(cfg) == want
    tau, _ = taus(DENSE)
    gap = tau * 0.75
    (d,) = _judge(DENSE, [0.0, 1.0, 0.97, 0.0], [0.0, 1.0, 1.0 - gap, 0.0])
    assert d["tau"] == tau and d["accepted"]
    monkeypatch.setitem(parity.READINGS["bfloat16"], "reduced",
                        {"all": (gap / 4, None)})
    (d,) = _judge(DENSE, [0.0, 1.0, 0.97, 0.0], [0.0, 1.0, 1.0 - gap, 0.0])
    assert d["tau"] == gap / 2 and not d["accepted"]


def test_float32_is_judged_by_float64_at_its_own_readings():
    """A float32 working type is judged by a float64 run at tau from
    the float32 readings, not bf16's: a tested token float32 ranks a
    hundredth below its top, which bf16's tau would accept, is refused,
    and the record names float64 as the exact run."""
    tau16, _ = taus(DENSE)
    tau32, _ = taus(DENSE32)
    assert tau32 == 2 * parity.READINGS["float32"]["reduced"]["dense"][0]
    assert tau32 < 0.01 < tau16
    (d,) = _judge(DENSE32, [0.0, 1.0, 0.99, 0.0], [0.0, 1.0, 0.99, 0.0])
    assert d["exact"] == "float64" and d["tau"] == tau32
    assert not d["accepted"] and "float64 picks 1" in parity.describe(d)
    with pytest.raises(ValueError, match="no near-tie reading"):
        taus(dataclasses.replace(get_config("qwen2-7b"), dtype="float16"))


def test_a_routing_tau_that_cannot_refuse_is_refused(monkeypatch):
    """A top-k / top-(k+1) margin is at most 1/k: a routing reading whose
    tau reaches it would accept any routing difference, so tau_route
    (and divergences judging routing) raises."""
    assert tau_route(CFG) < 1 / CFG.moe.top_k
    monkeypatch.setitem(parity.READINGS["bfloat16"], "reduced",
                        {"all": (0.05, 0.25)})                # tau 0.5
    with pytest.raises(ValueError, match="cannot refuse"):
        tau_route(CFG)
    ref_p = [0.4, 0.3, 0.2, 0.1]
    with pytest.raises(ValueError, match="cannot refuse"):
        _judge(CFG, [0.0, 1.0, 0.5, 0.0], [0.0, 1.0, 0.0, 0.0],
               probs={"ref": [ref_p], "exact": [ref_p]},
               engine_probs=[ref_p])


def test_float64_run_leaves_no_float32_arithmetic():
    """The exact run of a float32 model (reduced jamba: SSM, attention
    and MoE layers) computes every op in float64: no op under the mode
    returns float32 but an index or view of a float32 weight, and its
    logits lie within float32 rounding of the float32 run's."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(),
                              dtype="float32", use_kernels=False)
    params = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    eng = ServeEngine(cfg, params, max_len=64, device="cpu")
    prompt = np.arange(20, dtype=np.int32)
    seen = set()

    class Spy(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor) and o.dtype == torch.float32:
                    seen.add(getattr(func, "__name__", str(func)))
            return out

    exact = parity.exact_engine(eng)
    with Spy():
        got = exact.teacher_forced_logits(prompt, [1, 2, 3])
    assert seen <= {"__getitem__", "__get__"}, seen
    want = eng.teacher_forced_logits(prompt, [1, 2, 3])
    assert all(g.dtype == torch.float64 for g in got)
    assert max(float((g - w.double()).abs().max())
               for g, w in zip(got, want)) < 1e-4


def test_routing_log_follow_routes_as_the_log():
    """Routed as its own log, a run is unchanged; routed as another
    run's, it takes that run's top-k experts."""
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, CFG.vocab_size, (1, 9)))
    with routing_log() as own:
        want, _ = forward(CFG, params, {"tokens": toks})
    with routing_log(follow=own):
        same, _ = forward(CFG, params, {"tokens": toks})
    assert torch.equal(same, want)
    other = [p.flip(-1) for p in own]          # the bottom experts on top
    used = []
    topk = moe_module.router_topk
    with routing_log(follow=other):
        wrapped = moe_module.router_topk

        def spy(cfg, w, x):
            out = wrapped(cfg, w, x)
            used.append(out[1])
            return out
        moe_module.router_topk = spy
        try:
            forward(CFG, params, {"tokens": toks})
        finally:
            moe_module.router_topk = wrapped
    assert moe_module.router_topk is topk
    for idx, p in zip(used, other):
        assert torch.equal(idx.sort(-1).values,
                           parity._top_k(p, CFG.moe.top_k).sort(-1).values)


def test_calibration_measures_its_reduced_dense_reading():
    """The calibration script's measurement on the reduced dense model
    (its base and shared-prefix traces, the seed whose reading is the
    largest) lands on ``READINGS``'s dense entry: the constant is the
    script's reading."""
    sys.path.insert(0, str(SCRIPTS))
    try:
        import torch_near_tie_calibration as cal
    finally:
        sys.path.remove(str(SCRIPTS))
    rows = []
    cal.reduced_one(torch.device("cpu"), rows, "bfloat16",
                    CALIBRATION_SEED, 0, "qwen2-7b")
    fams, _ = cal.summarise(rows)
    reading = parity.READINGS["bfloat16"]["reduced"]["dense"][0]
    # the same measurement as the reading's, up to the CPU's bf16
    # rounding paths (thread count, vector width)
    assert fams["dense"]["logit"] == pytest.approx(reading, rel=0.25)


def test_routing_differences_finds_rows_and_reference_margins():
    ref = torch.tensor([[[0.40, 0.30, 0.20, 0.10],     # top-2 {0, 1}
                         [0.26, 0.25, 0.25, 0.24]]])   # top-2 {0, 1}, tie
    got = torch.tensor([[[0.30, 0.40, 0.20, 0.10],     # same set
                         [0.26, 0.24, 0.25, 0.25]]])   # {0, 2}
    diffs = routing_differences(2, [ref, got], [ref, ref])
    assert len(diffs) == 1
    call, rows = diffs[0]
    assert call == 1 and [r for r, _ in rows] == [1]
    assert rows[0][1] == pytest.approx(0.0)            # 0.25 - 0.25
    with pytest.raises(ValueError, match="do not pair up"):
        routing_differences(2, [ref], [ref, ref])


def test_routing_log_sees_every_moe_layer_and_changes_nothing():
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, CFG.vocab_size, (2, 9)))
    want, _ = forward(CFG, params, {"tokens": toks})
    with routing_log() as log:
        got, _ = forward(CFG, params, {"tokens": toks})
    assert len(log) == CFG.n_layers
    assert all(p.shape == (2, 9, CFG.moe.n_experts) for p in log)
    torch.testing.assert_close(log[0].sum(-1), torch.ones((2, 9)))
    assert torch.equal(got, want)
    with routing_log() as log:                          # restored after
        pass
    forward(CFG, params, {"tokens": toks})
    assert log == []


def test_float32_params_upcast_a_layer_at_a_time():
    """The float32 run's weights: the model's float32 logits from the
    lazily upcast layers equal those of a whole float32 copy, and the
    working-type layers are what the wrapper holds."""
    params = init_params(dataclasses.replace(CFG, dtype="bfloat16"),
                         torch.Generator().manual_seed(1), device="cpu")
    lazy = float32_params(params)
    held = list(list.__iter__(lazy["layers"]))
    assert held[0]["ffn"]["we_g"].dtype == torch.bfloat16
    assert lazy["layers"][0]["ffn"]["we_g"].dtype == torch.float32
    whole = {k: v for k, v in lazy.items() if k != "layers"}
    whole["layers"] = [layer for layer in lazy["layers"]]
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, CFG.vocab_size, (1, 7)))
    c32 = parity.float32_config(CFG)
    torch.testing.assert_close(forward(c32, lazy, {"tokens": toks})[0],
                               forward(c32, whole, {"tokens": toks})[0],
                               rtol=0, atol=0)


def test_divergences_explain_moe_streams_by_routing():
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    reqs = get_trace("shared_prefix")(8, CFG.vocab_size, seed=0,
                                      prefix_len=128)
    for r in reqs:
        r.n_steps = 16
    kernel = PagedServeEngine(CFG, params, max_len=256, max_batch=8,
                              page=64, device="cpu")
    plain = PagedServeEngine(dataclasses.replace(CFG, use_kernels=False),
                             params, max_len=256, max_batch=8, page=64,
                             device="cpu")
    k_res, _ = kernel.run(reqs)
    p_res, _ = plain.run(reqs)
    div = divergences(plain, reqs, p_res, k_res, engine=kernel)
    assert div, "the two paths' bf16 streams should part somewhere"
    assert all(d["accepted"] for d in div), [parity.describe(d) for d in div]
    assert any("routing" in d for d in div)       # the routing rule ran
    for d in div:
        stream_ok = d["exact_token"] == d["token"] or d["exact_gap"] < d["tau"]
        assert ("routing" in d) == (not stream_ok)
        if "routing" in d:
            assert all(r["accepted"] for r in d["routing"]["rows"].values())
    plain_only = divergences(plain, reqs, p_res, k_res)
    assert [d["step"] for d in plain_only] == [d["step"] for d in div]
    assert all("routing" not in d for d in plain_only)
