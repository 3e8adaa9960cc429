"""CPU tests of the readers of the program's own spans and counters
(``repro_torch.trace``): ``engine.scheduler_idle_share``,
``engine.host_self_share``, ``engine.prefill_row_fill``,
``moe_gmm.buffer_fill`` and ``engine.queue_wait_p90_ms``.

One subprocess runs each cell traced at a size the CPU holds inside
``trace.recording()`` (the harness starts no profiler on the CPU) and
dumps the window, the recorded spans and records and the results; each
reader's value is held to a count made here from the dump.  The same
chain, readers and all, loads neither JAX nor the JAX package.  Where
nothing was recorded, or the program has no recorder or no arrival
stamps, the readers return None.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from h100bench import spans as spans_mod  # noqa: E402
from h100bench.registry import Registry  # noqa: E402

CELLS = ["qwen3-moe-8l.chat", "qwen2-7b.longdoc"]
READERS = ["engine.scheduler_idle_share", "engine.host_self_share",
           "engine.prefill_row_fill", "moe_gmm.buffer_fill",
           "engine.queue_wait_p90_ms"]

CHAIN = r"""
import json, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and args and isinstance(args[0], str)
                 else None)
sys.path[:0] = [sys.argv[1] + "/bench", sys.argv[1] + "/src"]
import torch
torch.set_num_threads(2)
from h100bench import harness
from h100bench.tiny import small
from repro_torch import trace

runs = []


class Capture(harness.Run):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        runs.append(self)


harness.Run = Capture
dump = {}
for cell in sys.argv[2:]:
    trace.clear()
    with trace.recording():
        out = harness.run_cell(cell, 2**31 + 5, 1.0, True, t_start=0.0,
                               device="cpu", overrides=small(cell))
    run = runs[-1]
    dump[cell] = {
        "metrics": {k: v["value"] for k, v in out["metrics"].items()},
        "start": run.start, "end": run.end,
        "spans": [[s.name, s.id, s.parent, s.start, s.end, s.whole, s.attrs]
                  for s in trace.spans()],
        "records": [[r.name, r.parent, r.attrs, int(r.value().sum())]
                    for r in trace.records()],
        "results": [[r.admitted, r.admit_time, r.arrival_time]
                    for r in run.results]}
print(json.dumps({"cells": dump,
                  "modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "forbidden": harness.forbidden_modules(),
                  "opened": opened}))
"""


@pytest.fixture(scope="module")
def chain():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", CHAIN, str(ROOT), *CELLS],
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _window(d):
    """The whole ticks inside the window and their direct children, by
    hand from the dump."""
    lo, hi = d["start"] * 1e9, d["end"] * 1e9
    ticks = [s for s in d["spans"] if s[0] == "engine.tick" and s[5]
             and lo <= s[3] and s[4] <= hi]
    ids = {s[1] for s in ticks}
    kids = [s for s in d["spans"] if s[2] in ids]
    return ticks, kids


def _scheduler_idle(d):
    ticks, kids = _window(d)
    steps = sorted(s[3] for s in kids
                   if s[0] in ("engine.prefill", "engine.decode"))
    idle = 0
    for s in kids:
        if s[0] in ("engine.first_token", "engine.decode_wait"):
            later = [t for t in steps if t >= s[4]]
            if later:
                idle += later[0] - s[4]
    return 100.0 * idle / (ticks[-1][4] - ticks[0][3])


def _host_self(d):
    ticks, kids = _window(d)
    own = sum(t[4] - t[3] for t in ticks) - sum(s[4] - s[3] for s in kids)
    return 100.0 * own / (ticks[-1][4] - ticks[0][3])


def _row_fill(d):
    _, kids = _window(d)
    chunks = [s[6] for s in kids if s[0] == "engine.prefill"]
    return 100.0 * sum(a["nv"] for a in chunks) / sum(a["rows"]
                                                      for a in chunks)


def _buffer_fill(d):
    _, kids = _window(d)
    steps = {s[1] for s in kids if s[0] in ("engine.prefill",
                                             "engine.decode")}
    recs = [r for r in d["records"] if r[0] == "moe.dispatch"
            and r[1] in steps]
    return 100.0 * sum(r[3] for r in recs) / sum(
        r[2]["E"] * r[2]["B"] * r[2]["C"] for r in recs)


def _queue_wait(d):
    waits = [adm_t - arr_t for adm, adm_t, arr_t in d["results"]
             if adm >= 0 and d["start"] <= adm_t < d["end"]]
    return 1e3 * float(np.percentile(waits, 90))


BY_HAND = {"engine.scheduler_idle_share": _scheduler_idle,
           "engine.host_self_share": _host_self,
           "engine.prefill_row_fill": _row_fill,
           "moe_gmm.buffer_fill": _buffer_fill,
           "engine.queue_wait_p90_ms": _queue_wait}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name", READERS)
def test_reader_against_a_count_by_hand(chain, cell, name):
    d = chain["cells"][cell]
    listed = cell in next(m for m in Registry().benchmark()["per_layer"]
                          if m["name"] == name)["workloads"]
    assert (name in d["metrics"]) == listed
    if not listed:
        return
    ticks, kids = _window(d)
    assert len(ticks) >= 3 and any(s[0] == "engine.prefill" for s in kids)
    assert d["metrics"][name] == pytest.approx(BY_HAND[name](d), rel=1e-9)
    assert 0.0 <= d["metrics"][name] <= (1e9 if name.endswith("_ms")
                                         else 100.0)


def test_the_chain_loads_no_jax(chain):
    assert "repro_torch" in chain["modules"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(chain["modules"])
    assert chain["forbidden"] == []
    for name in READERS:
        assert any(f.endswith(f"/bench/metrics/{name}.py")
                   for f in chain["opened"])


class _Res:
    def __init__(self, admit, arrival=None):
        self.admitted, self.admit_time = 0, admit
        if arrival is not None:
            self.arrival_time = arrival


def test_none_when_nothing_was_recorded(monkeypatch):
    from repro_torch import trace
    reg = Registry()
    run = types.SimpleNamespace(start=1.0, end=2.0,
                                results=[_Res(1.5)])
    trace.clear()
    for name in READERS:
        assert reg.metric(name).read(run) is None, name
    # spans recorded outside the window are not the window's
    with trace.recording():
        with trace.span("engine.tick"):
            with trace.span("engine.prefill") as sp:
                sp.attrs.update(nv=1, rows=2)
    for name in READERS[:4]:
        assert reg.metric(name).read(run) is None, name
    trace.clear()
    # a program without the recorder
    monkeypatch.setattr(spans_mod, "trace", None)
    run.start, run.end = 0.0, float("inf")
    for name in READERS[:4]:
        assert reg.metric(name).read(run) is None, name
    run.results = [_Res(1.5, 1.25), _Res(1.75, 1.5)]
    assert reg.metric("engine.queue_wait_p90_ms").read(run) == \
        pytest.approx(1e3 * 0.25)
