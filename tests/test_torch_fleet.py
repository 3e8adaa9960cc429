"""The port's fleet capacity planner (``repro_torch.fleet``) against the
reference's (``repro.fleet``), on the same inputs, on the host (no model
runs here; ``test_torch_fleet_engine.py`` holds the replica to the
port's engine and the captured graphs to the reference's lowering).

Tolerances: the queueing model, the scenarios, the analytic graphs, the
replica and the fits are the same arithmetic in the same order, so they
must be equal exactly; frontier rows go through both packages' perf
engines, whose floats are held to rel 1e-12 (rounding, nothing else),
and everything else in a row exactly.  The CLI's stdout must be equal
character for character.
"""

import contextlib
import dataclasses
import importlib
import io
import math

import numpy as np
import pytest

from repro import fleet as ref_fleet
from repro.arch import overlay as ref_overlay
from repro.fleet import capacity as ref_capacity
from repro.fleet import cli as ref_cli
from repro.serve import api as ref_api
from repro.serve import resilience as ref_res
from repro_torch import fleet
from repro_torch.arch import overlay as port_overlay
from repro_torch.configs import ARCHS
from repro_torch.fleet import capacity, cli
from repro_torch.serve import api as port_api
from repro_torch.serve import resilience as port_res

REF_DEVICES = ("mi200", "mi300", "mi300x", "tpu_v5e", "tpu_v5p")
ENGINES = ("roofline", "mfma", "scoreboard")
OVERLAYS = ({}, {"mfma_scale": 2.0}, {"bw_scale": 1.5})
BUILTINS = ("bursty_batch", "chat", "long_context")
REL = 1e-12


def _cost(pkg, decode_ms=5.0, prefill_ms=20.0, max_batch=8, chunks=2):
    """tests/test_fleet.py's hand-built ServeCost."""
    return pkg.ServeCost(scenario="synthetic", device="unit",
                         max_batch=max_batch,
                         decode_tick_s=decode_ms / 1e3,
                         prefill_chunk_s=prefill_ms / 1e3,
                         decode_bound="memory", prefill_bound="compute",
                         prefill_chunks_per_request=chunks)


def _scn(pkg, **kw):
    """tests/test_fleet.py's scenario defaults."""
    kw.setdefault("name", "unit")
    kw.setdefault("prompt_mean", 512)
    kw.setdefault("output_mean", 64)
    kw.setdefault("max_batch", 8)
    kw.setdefault("prefill_chunk", 256)
    if "slo" in kw:
        kw["slo"] = pkg.SLO(**kw["slo"])
    return pkg.TrafficScenario(**kw)


# ---------------------------------------------------------------------------
# Queueing model
# ---------------------------------------------------------------------------

COSTS = {"fixture": {}, "fast": dict(decode_ms=1.0, prefill_ms=0.5,
                                     max_batch=32, chunks=1),
         "slow": dict(decode_ms=50.0, prefill_ms=300.0, max_batch=4,
                      chunks=16),
         "zero_tick": dict(decode_ms=0.0)}
SCENARIOS = {"default": {}, "bursty": dict(burstiness=4.0),
             "tight": dict(slo=dict(p99_token_ms=8.0)),
             "loose": dict(slo=dict(p99_token_ms=1e6)),
             "ttft": dict(slo=dict(p99_token_ms=1e6, ttft_p99_ms=45.0)),
             "idle_miss": dict(slo=dict(p99_token_ms=1.0))}
QPS = tuple(np.linspace(0.0, 4.0, 60)) + (10.0, 1e3, 1e9)


@pytest.mark.parametrize("scn_kw", list(SCENARIOS), ids=list(SCENARIOS))
@pytest.mark.parametrize("cost_kw", list(COSTS), ids=list(COSTS))
def test_queue_model_equals_reference(cost_kw, scn_kw):
    """Every queue function on a grid of per-device rates, and the
    bisection, equal to the reference's exactly."""
    pc, rc = _cost(fleet, **COSTS[cost_kw]), _cost(ref_fleet,
                                                   **COSTS[cost_kw])
    ps = _scn(fleet, **dict(SCENARIOS[scn_kw]))
    rs = _scn(ref_fleet, **dict(SCENARIOS[scn_kw]))
    assert pc.peak_tokens_per_s == rc.peak_tokens_per_s
    assert capacity.request_work_s(ps, pc) == \
        ref_capacity.request_work_s(rs, rc)
    for fn in ("token_latency_s", "ttft_s", "p99_latency_s"):
        got = [getattr(capacity, fn)(q, ps, pc) for q in QPS]
        want = [getattr(ref_capacity, fn)(q, rs, rc) for q in QPS]
        assert got == want, fn
    assert capacity.max_sustainable_qps(ps, pc) == \
        ref_capacity.max_sustainable_qps(rs, rc)
    slo = dict(p99_token_ms=25.0)
    assert capacity.max_sustainable_qps(ps, pc, slo=fleet.SLO(**slo),
                                        tol=1e-9) == \
        ref_capacity.max_sustainable_qps(rs, rc, slo=ref_fleet.SLO(**slo),
                                         tol=1e-9)


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------

def test_builtin_scenarios_equal_reference():
    assert fleet.list_scenarios() == ref_fleet.list_scenarios()
    assert set(BUILTINS) <= set(fleet.list_scenarios())
    for name in BUILTINS:
        p, r = fleet.get_scenario(name), ref_fleet.get_scenario(name)
        assert dataclasses.asdict(p) == dataclasses.asdict(r), name
        assert p.context_mean == r.context_mean
        assert p.prefill_chunks_per_request == r.prefill_chunks_per_request
        assert p.describe() == r.describe()
        assert p.slo.with_p99(50) == fleet.SLO(**dataclasses.asdict(
            r.slo.with_p99(50)))


@pytest.mark.parametrize("bad", [dict(qps=0.0), dict(qps=-1.0),
                                 dict(prompt_mean=0), dict(output_mean=0.5),
                                 dict(max_batch=0), dict(prefill_chunk=0),
                                 dict(tp=0)])
def test_scenario_validation_messages_equal_reference(bad):
    with pytest.raises(ValueError) as want:
        _scn(ref_fleet, name="bad", **bad)
    with pytest.raises(ValueError) as got:
        _scn(fleet, name="bad", **bad)
    assert str(got.value) == str(want.value)


def test_scenario_registry_messages_equal_reference():
    from repro_torch.fleet import scenario as mod
    for pkg in (fleet, ref_fleet):
        with pytest.raises(ValueError) as e:
            pkg.register_scenario(_scn(pkg, name="chat"))
        assert "already registered" in str(e.value)
    with pytest.raises(KeyError) as got:
        fleet.get_scenario("nope")
    with pytest.raises(KeyError) as want:
        ref_fleet.get_scenario("nope")
    assert str(got.value) == str(want.value)
    scn = fleet.register_scenario(_scn(fleet, name="test-port-roundtrip"))
    try:
        assert fleet.get_scenario("test-port-roundtrip") is scn
    finally:
        del mod._REGISTRY["test-port-roundtrip"]
    assert fleet.list_scenarios() == ref_fleet.list_scenarios()


# ---------------------------------------------------------------------------
# Analytic cost graphs
# ---------------------------------------------------------------------------

GRAPH_FIELDS = ("flops", "bytes_accessed", "collective_wire",
                "flash_block_bytes", "bytes_by_opcode", "key", "source")


def _graphs_equal(got, want):
    assert set(got) == set(want) == {"decode", "prefill"}
    for kind in want:
        g, w = got[kind], want[kind]
        assert [dataclasses.asdict(op) for op in g.ops] == \
            [dataclasses.asdict(op) for op in w.ops], kind
        for f in GRAPH_FIELDS:
            assert getattr(g, f) == getattr(w, f), (kind, f)


@pytest.mark.parametrize("name", BUILTINS)
def test_analytic_graphs_of_builtins_equal_reference(name):
    _graphs_equal(capacity.analytic_graphs(fleet.get_scenario(name)),
                  ref_capacity.analytic_graphs(
                      ref_fleet.get_scenario(name)))


@pytest.mark.parametrize("tp", [1, 4])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_analytic_graphs_of_every_catalog_config_equal_reference(arch, tp):
    """One scenario per catalog config, at full width, op for op."""
    kw = dict(name=f"catalog-{arch}", arch=arch, tp=tp)
    _graphs_equal(capacity.analytic_graphs(fleet.TrafficScenario(**kw)),
                  ref_capacity.analytic_graphs(
                      ref_fleet.TrafficScenario(**kw)))


# ---------------------------------------------------------------------------
# The frontier
# ---------------------------------------------------------------------------

def _rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, float) and math.isfinite(v):
                assert g[k] == pytest.approx(v, rel=REL, abs=0.0), k
            else:
                assert g[k] == v, k


@pytest.mark.parametrize("engine", ENGINES)
def test_fleet_report_equals_reference(engine):
    """Five devices x the three built-ins x three overlays, one engine a
    case: rows, the table and the cheapest device per scenario."""
    ovs = [port_overlay.Overlay(**kw) for kw in OVERLAYS]
    ref_ovs = [ref_overlay.Overlay(**kw) for kw in OVERLAYS]
    got = fleet.frontier(list(BUILTINS), REF_DEVICES, overlays=ovs,
                         engine=engine)
    want = ref_fleet.frontier(list(BUILTINS), REF_DEVICES, overlays=ref_ovs,
                              engine=engine)
    assert len(got.rows) == len(BUILTINS) * len(REF_DEVICES) * len(OVERLAYS)
    _rows_equal(got.as_dict()["rows"], want.as_dict()["rows"])
    assert got.table() == want.table()
    for name in BUILTINS:
        b, w = got.best(name), want.best(name)
        assert (b is None) == (w is None)
        if w is not None:
            _rows_equal([b.as_dict()], [w.as_dict()])


def test_frontier_infeasible_slo_equals_reference():
    kw = dict(name="chat-impossible")
    got = fleet.frontier(dataclasses.replace(
        fleet.get_scenario("chat"), slo=fleet.SLO(p99_token_ms=1e-3), **kw),
        ("mi300",))
    want = ref_fleet.frontier(dataclasses.replace(
        ref_fleet.get_scenario("chat"),
        slo=ref_fleet.SLO(p99_token_ms=1e-3), **kw), ("mi300",))
    assert not got.rows[0].feasible and got.best("chat-impossible") is None
    _rows_equal(got.as_dict()["rows"], want.as_dict()["rows"])
    assert got.table() == want.table()
    with pytest.raises(ValueError, match="frontier needs"):
        fleet.frontier([], ("mi300",))


def test_h100_roofline_is_finite_and_feasible():
    """The H100 has no price in the reference's table (1.0, any unlisted
    device's) and no cycle table: the roofline prices every built-in,
    the other two engines raise the pipeline's ValueError."""
    assert "h100" not in fleet.DEVICE_COST
    assert fleet.DEVICE_COST == ref_fleet.DEVICE_COST
    rep = fleet.frontier(list(BUILTINS), ("h100",),
                         overlays=[port_overlay.IDENTITY,
                                   port_overlay.Overlay(mfma_scale=2.0)])
    for r in rep.rows:
        assert r.feasible and 0 < r.max_qps < math.inf, r
        assert 1 <= r.devices_needed < 1000
        assert r.p99_token_ms <= r.slo_p99_ms
        assert math.isfinite(r.cost_per_mtok) and math.isfinite(r.ttft_ms)
        assert r.bound in ("compute", "memory", "collective")
    for name in BUILTINS:
        cost = fleet.serve_cost(name, "h100")
        assert cost.device == "h100" and cost.decode_tick_s > 0
        for engine in ("mfma", "scoreboard"):
            with pytest.raises(ValueError, match="roofline"):
                fleet.serve_cost(name, "h100", engine=engine)
    for engine in ("mfma", "scoreboard"):
        with pytest.raises(ValueError, match="roofline"):
            fleet.frontier("chat", ("mi300", "h100"), engine=engine)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--small"], ["--json"], ["--overlay", "mfma_scale=2"],
    ["--scenario", "chat", "--devices", "mi300", "--slo-p99-ms", "50",
     "--qps", "100", "--json"]],
    ids=["small", "json", "overlay", "overrides"])
def test_cli_stdout_equals_reference(argv):
    outs = []
    for main in (cli.main, ref_cli.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(list(argv)) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0]


def test_cli_parser_and_overlay_parsing():
    p, r = cli.build_parser(), ref_cli.build_parser()
    assert p.prog == "python -m repro_torch.fleet"
    assert vars(p.parse_args([])) == vars(r.parse_args([]))
    ov = cli.parse_overlay("mfma_scale=2, bw_scale=1.5")
    assert (ov.mfma_scale, ov.bw_scale) == (2.0, 1.5)
    for bad in ("warp_scale=2", "mfma_scale"):
        with pytest.raises(ValueError) as got:
            cli.parse_overlay(bad)
        with pytest.raises(ValueError) as want:
            ref_cli.parse_overlay(bad)
        assert str(got.value) == str(want.value)


def test_cli_h100_roofline_and_module_entry():
    """``--devices h100`` plans on the roofline; the package's
    ``__main__`` imports without running the CLI."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--scenario", "chat", "--devices", "h100"]) == 0
    assert "| chat | h100 | baseline |" in buf.getvalue()
    assert "cheapest feasible device is h100" in buf.getvalue()
    mod = importlib.import_module("repro_torch.fleet.__main__")
    assert mod.main is cli.main


# ---------------------------------------------------------------------------
# The replica against the reference's replica
# ---------------------------------------------------------------------------

def _random_case(seed):
    """A seeded overload trace (prompts, deadlines, cancellations) and the
    scheduler's settings, as plain values both packages can build."""
    rng = np.random.default_rng(seed)
    page = int(rng.choice([16, 32, 64, 128]))
    max_len = 160
    max_batch = int(rng.integers(1, 5))
    nb_table = math.ceil(max_len / page)
    full = max_batch * nb_table + 1
    n_blocks = None if rng.random() < 0.5 else int(
        rng.integers(nb_table + 1, full + 1))
    specs = []
    for _ in range(int(rng.integers(4, 14))):
        s = int(rng.integers(1, 120))
        n = int(rng.integers(1, max_len - s + 1))
        a = int(rng.integers(0, 25))
        deadline = a + int(rng.integers(0, 80)) if rng.random() < 0.4 \
            else None
        cancel = a + int(rng.integers(0, 60)) if rng.random() < 0.2 \
            else None
        prompt = rng.integers(0, 512, (s,)).astype(np.int32)
        specs.append((prompt, n, a, deadline, cancel))
    kw = dict(max_len=max_len, max_batch=max_batch, page=page,
              n_blocks=n_blocks,
              prefill_chunk=int(rng.choice([8, 16, 32])),
              max_queue=None if rng.random() < 0.5 else int(
                  rng.integers(1, 6)),
              max_preemptions=int(rng.integers(0, 4)), max_ticks=20000)
    slack = None if rng.random() < 0.4 else int(rng.integers(0, 4))
    faults = rng.random() < 0.7
    return specs, kw, slack, faults


def _sim(pkg_capacity, api, res, case, seed):
    specs, kw, slack, faults = case
    trace = [api.Request(prompt=p.copy(), n_steps=n, arrival=a,
                         deadline=d, cancel_at=c)
             for p, n, a, d, c in specs]
    plan = res.FaultPlan.random(seed, horizon=60) if faults else None
    policy = res.DeadlineAwareShed(slack=slack) if slack is not None \
        else None
    return pkg_capacity.simulate_trace(trace, admission=policy,
                                       fault_plan=plan, **kw), plan


@pytest.mark.parametrize("seed", range(16))
def test_replica_equals_reference_replica(seed):
    case = _random_case(seed)
    got, plan = _sim(capacity, port_api, port_res, case, seed)
    want, ref_plan = _sim(ref_capacity, ref_api, ref_res, case, seed)
    if plan is not None:
        assert [dataclasses.asdict(f) for f in plan.faults] == \
            [dataclasses.asdict(f) for f in ref_plan.faults]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_replica_validation_and_tuples():
    """The reference's two fit checks with its messages; a legacy tuple
    trace is coerced as the reference coerces it, to the same
    statistics, with a DeprecationWarning the first time."""
    for max_len, page, n_blocks in ((64, 64, None), (192, 128, 2)):
        errs = []
        for cap, api in ((capacity, port_api), (ref_capacity, ref_api)):
            big = api.Request(prompt=np.zeros(120, np.int32), n_steps=16)
            with pytest.raises(ValueError) as e:
                cap.simulate_trace([big], max_len=max_len, max_batch=2,
                                   page=page, n_blocks=n_blocks)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    kw = dict(max_len=64, max_batch=2, page=64)
    trace = [(np.zeros(8, np.int32), 4), (np.ones(6, np.int32), 3, 1)]
    want = ref_capacity.simulate_trace(list(trace), **kw)
    port_api._WARNED.clear()
    with pytest.warns(DeprecationWarning, match="tuples"):
        got = capacity.simulate_trace(list(trace), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(TypeError, match="Request"):
        capacity.simulate_trace([np.zeros(8, np.int32)], **kw)


def test_replica_models_block_backpressure():
    rng = np.random.default_rng(0)

    def mk(n):
        return [port_api.Request(prompt=rng.integers(0, 64, (8,)).astype(
            np.int32), n_steps=4, arrival=0) for _ in range(n)]

    tight = capacity.simulate_trace(mk(3), max_len=64, max_batch=3,
                                    page=128, n_blocks=3, prefill_chunk=32)
    roomy = capacity.simulate_trace(mk(3), max_len=64, max_batch=3,
                                    page=128, n_blocks=4, prefill_chunk=32)
    assert tight.ticks > roomy.ticks
    with pytest.raises(RuntimeError, match="max_ticks"):
        capacity.simulate_trace(mk(3), max_len=64, max_batch=3, page=128,
                                max_ticks=2)


# ---------------------------------------------------------------------------
# Tick-cost fits
# ---------------------------------------------------------------------------

def test_fit_tick_costs_recovers_exact_synthetic_costs():
    true = fleet.TickCosts(decode_s=3e-3, prefill_s=1.5e-3, overhead_s=2e-4)
    obs, ref_obs = [], []
    for d, p, t in [(10, 2, 13), (3, 9, 12), (20, 5, 26), (7, 7, 20)]:
        kw = dict(requests=1, tokens=d + 1, ticks=t, decode_steps=d,
                  prefill_chunks=p, occupancy_mean=0.5, occupancy_max=1.0)
        st = fleet.SimStats(**kw)
        obs.append((st, true.wall_s(st)))
        ref_obs.append((ref_fleet.SimStats(**kw), true.wall_s(st)))
    fit = fleet.fit_tick_costs(obs)
    assert dataclasses.asdict(fit) == dataclasses.asdict(
        ref_fleet.fit_tick_costs(ref_obs))
    assert fit.decode_s == pytest.approx(true.decode_s, rel=1e-6)
    assert fit.prefill_s == pytest.approx(true.prefill_s, rel=1e-6)
    assert fit.overhead_s == pytest.approx(true.overhead_s, rel=1e-6)
    st = obs[0][0]
    assert fit.token_latency_s(st) == ref_fleet.fit_tick_costs(
        ref_obs).token_latency_s(st)
    with pytest.raises(ValueError, match=">= 3"):
        fleet.fit_tick_costs(obs[:2])
    # a degenerate probe set clamps a negative primitive at 0, as the
    # reference does
    neg = [(s, w - 0.05 * s.prefill_chunks) for s, w in obs]
    assert fleet.fit_tick_costs(neg) == fleet.TickCosts(**dataclasses.asdict(
        ref_fleet.fit_tick_costs([(ref_fleet.SimStats(
            **dataclasses.asdict(s)), w) for s, w in neg])))


def test_exports_equal_reference():
    want = [n if n != "hlo_graphs" else "torch_graphs"
            for n in ref_capacity.__all__]
    assert capacity.__all__ == want
    assert fleet.__all__ == ref_fleet.__all__
    # the packages re-export the function ``frontier`` under the module's
    # name, so take the modules from importlib
    for mod in ("frontier", "scenario"):
        assert importlib.import_module(f"repro_torch.fleet.{mod}").__all__ \
            == importlib.import_module(f"repro.fleet.{mod}").__all__
