"""The fleet planner's calibration layer against the port's engine, and
its captured cost graphs against the reference's lowering, on the CPU.

* The replica (``simulate_trace``) is tick-exact against the port's
  ``PagedServeEngine`` serving the reduced qwen2-7b at the reference
  test's settings (``tests/test_fleet.py``: ``max_len`` 160, two slots,
  page 128, chunk 32, no prefix cache) on its four trace mixes, and on
  the overload trace with faults, a queue bound and deadline-aware
  shedding (``tests/test_serve_resilience.py``'s).  Every counter equal;
  occupancy to 1e-12 (the same ratios, averaged by numpy).  The
  reference's calibration band (tick costs fitted from measured walls
  predicting a held-out trace within [0.5, 2.0]x) is held on the card
  (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 23): on the
  CPU under the suite's workers the walls share the cores, and five
  runs read 0.75-2.28x.
* ``torch_graphs`` (the port's plain path captured on the meta device)
  against ``hlo_graphs`` (the reference's, compiled by XLA:CPU with
  faithful bf16 dots, ``REPRO_CPU_F32_DOTS=0``) on ``chat``: the dot
  FLOPs are equal once the named sites below are set aside, and so are
  the dot sites (an m x n product counted with its n x m transpose).

Named site differences, each with its reason:

* ``DECODE_F32_SITES``: XLA:CPU runs the decode step's two attention
  products (q.k^T and p.v) on f32 copies of the bf16 operands, so the
  reference's parse types them f32; the port records them bf16, as a
  matrix unit runs them (``tests/test_torch_graph.py`` names the same).
* ``PREFILL_RECOMPUTED_SITES``: the port's prefill recomputes each
  attention layer's q, k and v projections for its cache
  (``blocks._attn_prefill_cache``, as the reference's model does);
  XLA's CSE merges the k and v products with the attention's and drops
  the unused q, so the reference's graph has them once.
* ``PREFILL_LM_HEAD_SITE``: XLA:CPU fuses the prefill's one-row LM-head
  product into a loop fusion, which the reference's parser charges as
  bytes at its call site and not as a dot; the port records the product.
"""

import math

import numpy as np
import pytest
import torch

from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from repro.fleet import get_scenario as ref_get_scenario
from repro.fleet.capacity import hlo_graphs
from repro_torch.configs import get_config
from repro_torch.fleet import get_scenario, simulate_trace
from repro_torch.fleet.capacity import torch_graphs
from repro_torch.models import init_params
from repro_torch.serve import (DeadlineAwareShed, Fault, FaultPlan,
                               PagedServeEngine, Request, get_trace)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = get_config("qwen2-7b").reduced()
#: tests/test_fleet.py's engine settings
SETTINGS = dict(max_len=160, max_batch=2, page=128, prefill_chunk=32,
                prefix_cache=False)
#: tests/test_fleet.py's four mixes: (prompt length, n_steps, arrival)
TRACES = {
    "decode_heavy": [(6, 24, 0), (9, 30, 0), (7, 18, 1)],
    "prefill_heavy": [(130, 3, 0), (120, 2, 0), (96, 2, 1)],
    "gapped": [(8, 6, 0), (10, 5, 14), (12, 4, 30)],
    "mixed": [(64, 10, 0), (9, 20, 0), (100, 4, 2), (12, 12, 3)],
}
COUNTERS = ("requests", "tokens", "ticks", "decode_steps", "prefill_chunks",
            "completed", "shed", "timeouts", "cancelled", "preemptions",
            "stalled_ticks")


def _trace(specs, seed=7):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, CFG.vocab_size, (s,))
                    .astype(np.int32), n_steps=n, arrival=a)
            for s, n, a in specs]


def _sim_kwargs(eng):
    return dict(max_len=eng.max_len, max_batch=eng.max_batch, page=eng.page,
                n_blocks=eng.cache.n_blocks, prefill_chunk=eng.prefill_chunk)


def _assert_tick_exact(sim, stats):
    for field in COUNTERS:
        assert getattr(sim, field) == stats[field], field
    assert sim.occupancy_max == pytest.approx(stats["occupancy_max"],
                                              rel=0, abs=1e-12)
    assert sim.occupancy_mean == pytest.approx(stats["occupancy_mean"],
                                               rel=0, abs=1e-12)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture(scope="module")
def engine(params):
    return PagedServeEngine(CFG, params, device="cpu", **SETTINGS)


@pytest.mark.parametrize("name", list(TRACES))
def test_replica_is_tick_exact_against_the_port_engine(engine, name):
    _, stats = engine.run(_trace(TRACES[name]))
    sim = simulate_trace(_trace(TRACES[name]), **_sim_kwargs(engine))
    _assert_tick_exact(sim, stats)


def test_replica_is_tick_exact_on_overload_with_faults(params):
    """tests/test_serve_resilience.py's degraded regime: the same trace,
    policy and fault plan through the engine and the replica."""
    trace = get_trace("overload")(10, CFG.vocab_size, seed=3)
    plan = FaultPlan(faults=[Fault("exhaust", tick=4, n=2, duration=3),
                             Fault("preempt", tick=8, n=1),
                             Fault("stall", tick=11, duration=2)])
    policy = DeadlineAwareShed(slack=2)
    eng = PagedServeEngine(CFG, params, device="cpu", max_queue=4,
                           admission=policy, **SETTINGS)
    _, stats = eng.run(trace, fault_plan=plan, max_ticks=5000)
    sim = simulate_trace(get_trace("overload")(10, CFG.vocab_size, seed=3),
                         max_queue=4, admission=policy, fault_plan=plan,
                         max_ticks=5000, **_sim_kwargs(eng))
    _assert_tick_exact(sim, stats)
    assert stats.shed + stats.timeouts > 0          # overload actually bit
    assert stats.preemptions > 0 and stats.stalled_ticks == 2


# ---------------------------------------------------------------------------
# Captured graphs against the reference's lowering
# ---------------------------------------------------------------------------

CHAT = get_scenario("chat")
B = CHAT.max_batch
#: hlo_graphs' cache length and chunk for chat (the same arithmetic)
T = min(512, 1 << max(4, int(math.ceil(math.log2(max(
    2.0, CHAT.context_mean / 16.0))))))
C = min(CHAT.prefill_chunk, T // 2)
H, KV, HD, D = CFG.n_heads, CFG.n_kv_heads, CFG.hd, CFG.d_model
#: (batch, min(m, n), max(m, n), k) -> calls: see the module docstring
DECODE_F32_SITES = {(B * H, 1, T, HD): CFG.n_layers,
                    (B * H, 1, HD, T): CFG.n_layers}
PREFILL_RECOMPUTED_SITES = {(1, C, H * HD, D): CFG.n_layers,
                            (1, C, KV * HD, D): 2 * CFG.n_layers}
PREFILL_LM_HEAD_SITE = {(1, 1, CFG.vocab_size, D): 1}


@pytest.fixture(scope="module")
def graphs():
    """(port, reference) graphs of chat: one capture pair, two compiles."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_CPU_F32_DOTS", "0")
        ref = hlo_graphs(ref_get_scenario("chat"))
    return torch_graphs(CHAT), ref


def _sites(graph, dtype=True):
    out = {}
    for op, cnt in graph.dot_pairs():
        key = (op.batch, min(op.m, op.n), max(op.m, op.n), op.k)
        if dtype:
            key += (op.dtype,)
        out[key] = out.get(key, 0) + cnt
    return out


def _flops(sites):
    return sum(2 * b * m * n * k * cnt for (b, m, n, k), cnt in sites.items())


def test_decode_graph_equals_reference_but_for_named_sites(graphs):
    port, ref = graphs[0]["decode"], graphs[1]["decode"]
    assert port.source == "torch" and port.flops == ref.flops
    f32 = {s[:4] for s in _sites(ref) if s[4] == "f32"}
    assert f32 == set(DECODE_F32_SITES)
    assert {s[4] for s in _sites(port)} == {"bf16"}
    assert _sites(port, dtype=False) == _sites(ref, dtype=False)


def test_prefill_graph_equals_reference_but_for_named_sites(graphs):
    port, ref = graphs[0]["prefill"], graphs[1]["prefill"]
    named = dict(PREFILL_RECOMPUTED_SITES)
    named.update(PREFILL_LM_HEAD_SITE)
    assert port.flops == ref.flops + _flops(named)
    got = _sites(port, dtype=False)
    for site, calls in named.items():
        got[site] -= calls
        if not got[site]:
            del got[site]
    assert got == _sites(ref, dtype=False)
    assert {s[4] for s in _sites(port)} == {"bf16"}
    assert {s[4] for s in _sites(ref)} == {"bf16"}


def test_serve_cost_prices_the_captured_graphs(graphs):
    """``serve_cost(source=...)``: anything but "analytic" prices the
    captured graphs, as the reference's takes its compiled ones."""
    from repro_torch.fleet import serve_cost
    from repro_torch.perf import predict
    got = serve_cost(CHAT, "h100", source="torch")
    for kind, t in (("decode", got.decode_tick_s),
                    ("prefill", got.prefill_chunk_s)):
        want = predict(graphs[0][kind], device="h100", engine="roofline")
        assert t == want.total_time_s, kind
    analytic = serve_cost(CHAT, "h100")
    assert analytic.decode_tick_s > 100 * got.decode_tick_s
