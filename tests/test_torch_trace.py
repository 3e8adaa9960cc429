"""The port's recorder (``repro_torch.trace``) and the spans and counters
of the paged engine and the MoE dispatch, on the CPU.

* Off, a site costs a flag check: nothing is recorded, no
  ``record_function`` is opened, and every site gets the shared no-op.
* On (``trace.recording()``), a tiny engine serving a prefix-sharing
  trace records one ``engine.tick`` a tick with its prefill chunks,
  first tokens, decode steps and decode waits nested inside, as many as
  ``RunStats`` counts, carrying the requests' indices; every admitted
  request has ``arrival_time <= admit_time <= emit_times[0]``.
* Recording changes no token, status, tick or ``RunStats`` field.
* ``moe.dispatch``'s kept rows per expert equal a count made from the
  router's assignments, clamped at the capacity.
* Under ``torch.profiler`` every recorded span is a ``user_annotation``
  of the same name and nesting in the exported Chrome trace, and one
  map from ``perf_counter`` to the trace's wall-clock stamps puts every
  annotation around its span: an offset, and the rate at which the
  wall clock ran against ``perf_counter`` through the run (1 unless
  the OS is slewing the wall clock).
"""

import collections
import dataclasses
import json
import math
import time

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.models.model import init_params
from repro_torch.models.moe import capacity, init_moe, moe_apply, router_topk
from repro_torch.serve import PagedServeEngine, get_trace

ENGINE = dict(device="cpu", max_len=128, max_batch=4, page=16,
              prefill_chunk=16)
STEPS = ("engine.prefill", "engine.first_token", "engine.decode",
         "engine.decode_wait")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch CPU thread: tiny steps are many small ops."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def empty_recorder():
    trace.clear()
    yield
    trace.clear()


def _model(name):
    cfg = get_config(name).reduced()
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def _trace(cfg):
    return get_trace("shared_prefix")(6, cfg.vocab_size, seed=0,
                                      prefix_len=32)


def _serve(name):
    """A fresh engine serving the prefix-sharing trace."""
    cfg, params = _model(name)
    reqs = _trace(cfg)
    results, stats = PagedServeEngine(cfg, params, **ENGINE).run(reqs)
    return reqs, results, stats


def test_off_records_nothing_and_opens_no_record_function(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(*a, **k):
        opened.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not trace.active()
    assert trace.span("engine.tick") is trace.NOOP
    assert trace.count("moe.dispatch") is trace.NOOP
    with trace.span("engine.tick") as sp:
        assert not sp
    _, results, stats = _serve("qwen3-moe-235b-a22b")
    assert stats.decode_steps > 0 and stats.prefill_chunks > 0
    assert trace.spans() == [] and trace.records() == []
    assert opened == []
    # the tick's start is stamped all the same
    assert all(r.arrival_time > 0.0 for r in results)


def test_spans_nest_count_and_name_the_requests():
    with trace.recording():
        reqs, results, stats = _serve("qwen2-7b")
    assert stats.prefix_blocks_reused > 0 and stats.preemptions == 0
    spans = trace.spans()
    assert all(s.whole and s.end >= s.start for s in spans)
    ticks = {s.id: s for s in spans if s.name == "engine.tick"}
    assert [s.attrs["tick"] for s in ticks.values()] == \
        list(range(stats.ticks))
    assert all(s.parent is None for s in ticks.values())
    steps = [s for s in spans if s.name != "engine.tick"]
    assert {s.name for s in steps} == set(STEPS)
    for s in steps:
        tick = ticks[s.parent]
        assert tick.start <= s.start and s.end <= tick.end
    by_name = collections.defaultdict(list)
    for s in steps:
        by_name[s.name].append(s)
    assert len(by_name["engine.prefill"]) == stats.prefill_chunks
    assert len(by_name["engine.decode"]) == stats.decode_steps
    assert len(by_name["engine.decode_wait"]) == stats.decode_steps
    # every chunk of a request's uncached prompt, its first token, and
    # one decode step for each token after it
    page, C = ENGINE["page"], ENGINE["prefill_chunk"]
    chunks = collections.Counter(s.attrs["req"]
                                 for s in by_name["engine.prefill"])
    decoded = collections.Counter(i for s in by_name["engine.decode"]
                                  for i in s.attrs["reqs"])
    firsts = [s.attrs["req"] for s in by_name["engine.first_token"]]
    assert sorted(firsts) == list(range(len(reqs)))
    for i, (q, r) in enumerate(zip(reqs, results)):
        uncached = q.prompt.shape[0] - r.prefix_blocks * page
        assert chunks[i] == math.ceil(uncached / C)
        mine = [s.attrs for s in by_name["engine.prefill"]
                if s.attrs["req"] == i]
        assert [a["pos"] for a in mine] == \
            list(range(r.prefix_blocks * page, q.prompt.shape[0], C))
        assert sum(a["nv"] for a in mine) == uncached
        assert decoded[i] == len(r.tokens) - 1
        assert r.arrival_time <= r.admit_time <= r.emit_times[0]
    for s in by_name["engine.prefill"]:
        assert 0 < s.attrs["nv"] <= s.attrs["rows"] == C
    for s in by_name["engine.decode"]:
        assert s.attrs["n"] == len(s.attrs["reqs"])
        assert s.attrs["max_batch"] == ENGINE["max_batch"]


@pytest.mark.parametrize("name", ["qwen2-7b", "qwen3-moe-235b-a22b"])
def test_recording_changes_no_token_status_tick_or_stat(name):
    _, off, off_stats = _serve(name)
    with trace.recording():
        _, on, on_stats = _serve(name)
    assert trace.spans()
    assert dataclasses.asdict(off_stats) == dataclasses.asdict(on_stats)
    for a, b in zip(off, on, strict=True):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.status, a.arrival, a.admitted, a.finished,
                a.prefix_blocks, a.preemptions) == \
            (b.status, b.arrival, b.admitted, b.finished, b.prefix_blocks,
             b.preemptions)


@pytest.mark.parametrize("router", ["drawn", "tied"])
def test_moe_dispatch_counts_kept_rows(router):
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    w = init_moe(cfg, torch.Generator().manual_seed(1), torch.device("cpu"))
    if router == "tied":            # every token picks experts 0 and 1
        w["router"] = torch.zeros_like(w["router"])
    B, S = 3, 16
    x = torch.randn((B, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(2)).to(
                        torch.bfloat16)
    with trace.recording():
        moe_apply(cfg, w, x)
    (rec,) = trace.records()
    E, C = cfg.moe.n_experts, capacity(cfg, S)
    assert rec.name == "moe.dispatch" and rec.parent is None
    assert rec.attrs == {"E": E, "B": B, "C": C}
    _, idx, _ = router_topk(cfg, w["router"], x)
    per_group = torch.nn.functional.one_hot(
        idx.reshape(B, -1), E).sum(1)                            # (B, E)
    want = per_group.clamp(max=C).sum(0).numpy()
    if router == "tied":
        assert (per_group[:, 0] > C).all()                     # overflow
    np.testing.assert_array_equal(rec.value(), want)
    np.testing.assert_array_equal(rec.value(), want)           # read once


def test_recorder_opens_only_while_on_and_marks_cut_spans():
    with trace.span("outer"):       # off at its opening: never recorded
        with trace.recording():
            with trace.span("inner") as inner:
                pass
            cut = trace.span("cut").__enter__()
        cut.__exit__(None, None, None)
    assert [s.name for s in trace.spans()] == ["inner", "cut"]
    assert inner.parent is None and inner.whole and not cut.whole
    with trace.recording():
        with trace.span("a") as a:
            with trace.span("b") as b:
                rec = trace.count("c")
                rec.hold(torch.arange(6).reshape(2, 3),
                         lambda t: t.sum(0))
    assert (b.parent, rec.parent) == (a.id, b.id)
    np.testing.assert_array_equal(rec.value(), [3, 5, 7])


def test_profiler_stopped_inside_a_span_cuts_it():
    """A profiler that stops while a span it opened is still open (the
    end of a traced slice) leaves the span closed, recorded and cut."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with trace.span("engine.decode") as sp:
        prof.stop()
        assert trace.span("engine.decode_wait") is trace.NOOP
    assert trace.spans() == [sp] and not sp.whole and sp.end >= sp.start


def test_ring_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(trace._state, "ring", collections.deque(maxlen=3))
    with trace.recording():
        for i in range(5):
            with trace.span(f"s{i}"):
                pass
    assert [s.name for s in trace.spans()] == ["s2", "s3", "s4"]


def test_spans_share_the_profilers_clock(tmp_path):
    cfg, params = _model("qwen2-7b")
    reqs = _trace(cfg)
    eng = PagedServeEngine(cfg, params, **ENGINE)
    # a process's first annotation looks up the profiler's ops (~0.3 ms
    # between the two clocks' readings): take it before the measured run
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("warm-up"):
            pass
    wall0, mono0 = time.time_ns(), time.perf_counter_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.run(reqs)
        wall1, mono1 = time.time_ns(), time.perf_counter_ns()
    spans = [s for s in trace.spans() if s.name.startswith("engine.")]
    assert spans and not trace.active()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    notes = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("engine.")),
                   key=lambda e: (float(e["ts"]), -float(e["dur"])))
    assert [e["name"] for e in notes] == [s.name for s in spans]
    note_of = {s.id: e for s, e in zip(spans, notes)}
    for s in spans:
        if s.parent is not None:
            e, p = note_of[s.id], note_of[s.parent]
            assert float(p["ts"]) <= float(e["ts"])
            assert float(e["ts"]) + float(e["dur"]) <= \
                float(p["ts"]) + float(p["dur"])
    # the trace stamps the wall clock: the map's rate is the one the wall
    # clock ran at against perf_counter, fitted on the spans' starts
    starts = np.array([s.start for s in spans], dtype=np.float64) / 1e3
    ends = np.array([s.end for s in spans], dtype=np.float64) / 1e3
    ts = np.array([float(note_of[s.id]["ts"]) for s in spans])
    dur = np.array([float(note_of[s.id]["dur"]) for s in spans])
    rate = np.polyfit(starts - starts[0], ts - starts, 1)[0] + 1
    assert abs(rate - (wall1 - wall0) / (mono1 - mono0)) < 1e-3
    # each annotation opens before its span's start and closes after its
    # end, so an offset that fits every span lies in [lo, hi]; a delay of
    # the host between two reads (a preempted worker) only widens that
    lo = (ts - rate * (starts - starts[0])).max()
    hi = (ts + dur - rate * (ends - starts[0])).min()
    assert lo - hi < 1e3                            # microseconds
