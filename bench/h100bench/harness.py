"""One run of one cell: set-up, the measured window, the output check.

The program under test is ``repro_torch``'s continuous-batching engine,
``PagedServeEngine.run``, with the port's kernels on.  A run:

1. makes the weights on the device from the seed (:mod:`.weights`) and
   builds the engine at the cell's sizes;
2. warms up the cell's own shapes: one prefill chunk and the decode
   step at the cell's batch, twice (the first call builds and loads the
   kernels), and reads the decode step's time;
3. generates the trace from the seed (:mod:`.traffic`), enough for four
   windows at that decode time, every request cancelled at its horizon;
4. serves it in one ``run()``.  The window opens at the start of the
   cell's ``start_step``-th decode step and lasts ``seconds`` of wall
   time; ``drain`` decode steps after it closes, every request still
   queued or in flight is cancelled (``cancel_at = 0``, the client
   giving up), so that every request admitted in the window has had its
   first token and the run ends soon after the window;
5. reads ``memory_peak_bytes``, frees the program's state and holds the
   window's served tokens to the plain reference (:mod:`.check`);
6. computes the cell's metrics, each by its reader in ``bench/metrics``.

``setup_s`` is the time from the process's start to the window's.

With ``trace`` the run reports the per-layer metrics instead of the
end-to-end ones: the window's engine steps are synchronised before and
after, so each has a wall time of its own, until ``torch.profiler``
traces the window's last ``trace_seconds`` (nothing else changes
there; the profiler stops, and processes what it recorded, after the
window).  The wrappers around the engine's two steps and
around the MoE router and ``moe_gmm`` are the benchmark's own spans and
counters; the program is not changed.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import time
from typing import List, Optional

import numpy as np

from h100bench import check, model, peaks, traffic, weights, window
from h100bench import trace as trace_mod
from h100bench.registry import Registry

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Step:
    """One call of the engine's ``prefill`` or ``decode``."""
    t: float                    # host clock at the call
    in_window: bool
    profiled: bool              # inside the traced slice
    wall: Optional[float]       # synchronised wall time (traced runs)
    routers: range              # indices of the MoE router calls it made
    pos: int = 0                # prefill: the chunk's start
    nv: int = 0                 # prefill: its valid rows
    lens: Optional[np.ndarray] = None   # decode: every slot's cache length


class Probe:
    """Wraps the engine's two steps (and, traced, the MoE router and
    ``moe_gmm``) to open and close the window and record each call."""

    def __init__(self, engine, *, start_step: int, seconds: float,
                 drain: int, trace_seconds: float, traced: bool, sync):
        self.engine = engine
        self.start_step, self.seconds, self.drain = start_step, seconds, drain
        self.trace_seconds, self.traced, self.sync = trace_seconds, traced, sync
        self.prefills: List[Step] = []
        self.decodes: List[Step] = []
        self.warm_decodes: List[Step] = []
        self.router_rows: list = []     # (E,) assigned rows a router call
        self.gmm: list = []             # (E, R, K, N, router index, profiled)
        self.reqs: list = []
        self.start = self.end = None
        self.close_step = None
        self.profiler = None
        self.profiling = False
        self.warm = True
        self._prefill, self._decode = engine.prefill, engine.decode
        engine.prefill, engine.decode = self.prefill, self.decode
        self._patched = []

    # -- MoE counters (traced runs) -----------------------------------------
    def patch_moe(self) -> None:
        import torch
        from repro_torch.models import moe as moe_mod
        router, gmm = moe_mod.router_topk, moe_mod.moe_gmm
        probe = self

        def router_topk(cfg_, w_router, x):
            gates, idx, aux = router(cfg_, w_router, x)
            if not probe.warm:
                G, S, K = idx.shape
                E = cfg_.moe.n_experts
                counts = torch.zeros((G, E), dtype=torch.int32,
                                     device=idx.device)
                counts.scatter_add_(1, idx.reshape(G, S * K).long(),
                                    torch.ones_like(idx.reshape(G, S * K),
                                                    dtype=torch.int32))
                cap = moe_mod.capacity(cfg_, S)
                probe.router_rows.append(counts.clamp_(max=cap).sum(0))
            return gates, idx, aux

        def moe_gmm(x, w):
            if not probe.warm:
                E, R, K = x.shape
                probe.gmm.append((E, R, K, w.shape[-1],
                                  len(probe.router_rows) - 1,
                                  probe.profiling))
            return gmm(x, w)

        self._patched = [(moe_mod, "router_topk", router),
                         (moe_mod, "moe_gmm", gmm)]
        moe_mod.router_topk, moe_mod.moe_gmm = router_topk, moe_gmm

    def restore(self) -> None:
        for mod, name, fn in self._patched:
            setattr(mod, name, fn)
        self._patched = []
        if self.engine is not None:
            vars(self.engine).pop("prefill", None)
            vars(self.engine).pop("decode", None)
            self.engine = None
        self._prefill = self._decode = None

    # -- the engine's steps ----------------------------------------------------
    def _call(self, fn, label, *args):
        """Run one step: timed and synchronised when the traced run is in
        its window past the traced slice (and during warm-up)."""
        synced = self.warm or (self.traced and self.in_window()
                               and not self.profiling)
        if self.profiling:
            import torch
            with torch.profiler.record_function(label):
                return fn(*args), None
        if not synced:
            return fn(*args), None
        self.sync()
        t0 = time.perf_counter()
        out = fn(*args)
        self.sync()
        return out, time.perf_counter() - t0

    def in_window(self) -> bool:
        return self.start is not None and self.close_step is None

    def prefill(self, tokens, table, pos, nv):
        t = time.perf_counter()
        r0 = len(self.router_rows)
        out, wall = self._call(self._prefill, "bench.prefill", tokens, table,
                               pos, nv)
        if not self.warm:
            self.prefills.append(Step(
                t=t, in_window=self.in_window(), profiled=self.profiling,
                wall=wall, routers=range(r0, len(self.router_rows)),
                pos=int(pos), nv=int(nv)))
        return out

    def decode(self, pend, tables, lens):
        t = time.perf_counter()
        if not self.warm:
            self._advance(t)
        r0 = len(self.router_rows)
        profiled = self.profiling
        out, wall = self._call(self._decode, "bench.decode", pend, tables,
                               lens)
        rec = Step(t=t, in_window=self.in_window(), profiled=profiled,
                   wall=wall, routers=range(r0, len(self.router_rows)),
                   lens=np.array(lens, copy=True))
        (self.warm_decodes if self.warm else self.decodes).append(rec)
        return out

    def _advance(self, t: float) -> None:
        """Open, close and drain the window at the start of a decode
        step; start and stop the profiler."""
        step = len(self.decodes)
        if self.start is None and step >= self.start_step:
            self.start, self.end = t, t + self.seconds
        if self.close_step is None and self.start is not None \
                and t >= self.end:
            self.close_step = step
            if self.profiling:
                self.profiler.stop()
                self.profiling = False
        elif self.profiler is not None and not self.profiling \
                and self.close_step is None and self.start is not None \
                and t >= self.end - self.trace_seconds:
            self.profiler.start()
            self.profiling = True
        if self.close_step is not None \
                and step - self.close_step == self.drain:
            for r in self.reqs:
                r.cancel_at = 0


@dataclasses.dataclass
class Run:
    """What a metric reader gets: the cell's files, the window and every
    record of it."""
    cell: str
    c: dict                     # the config file
    d: dict                     # its sizes (weights.dims)
    workload: dict
    mix: dict
    seconds: float
    start: float
    end: float
    results: list
    trace: list                 # the generator's requests, in input order
    prefills: List[Step]
    decodes: List[Step]
    router_rows: list           # (E,) numpy arrays
    gmm: list
    device_trace: Optional["trace_mod.Summary"]
    registry: Registry
    peaks: object = peaks


def _hold_cuda():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark measures the card "
                           "and does not fall back to the CPU")


def run_cell(cell: str, seed: int, seconds: float, traced: bool, *,
             t_start: float, device: str = "cuda",
             registry: Optional[Registry] = None,
             overrides: Optional[dict] = None, control: bool = False) -> dict:
    """One run of ``cell``; returns the result line's object (with the
    compared numbers under ``"compared"``) and, under ``"_check"``, the
    output check's detail and ``"_setup"`` the set-up's phases.
    ``overrides`` ({"config": {...}, "traffic": {...}, "workload":
    {...}}) resizes the cell for tests on the CPU; ``control`` also
    reads the control (:func:`check.control_gaps`) into ``"_control"``."""
    import torch
    from repro_torch.serve import PagedServeEngine

    reg = registry or Registry()
    wl = dict(reg.workload(cell))
    c = dict(reg.config(wl["config"]))
    mix = dict(reg.traffic(wl["traffic"]))
    for part, d in (overrides or {}).items():
        {"config": c, "traffic": mix, "workload": wl}[part].update(d)
    dev = torch.device(device)
    if dev.type == "cuda":
        _hold_cuda()
    cfg = model.port_config(c)
    d = weights.dims(c)
    marks = {"imports": time.perf_counter()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    params = weights.make_weights(c, seed, dev)
    sync()
    marks["weights"] = time.perf_counter()
    probe = Probe(PagedServeEngine(cfg, params, device=dev, **wl["engine"]),
                  start_step=wl["start_step"], seconds=seconds,
                  drain=math.ceil(traffic.longest(mix)
                                  / wl["engine"]["prefill_chunk"]) + 1,
                  trace_seconds=wl["trace_seconds"],
                  traced=traced, sync=sync)
    if traced and cfg.moe is not None:
        probe.patch_moe()
    try:
        return _serve_and_check(
            cell, seed, seconds, traced, t_start, reg, wl, c, d, mix,
            params, probe, sync, dev, marks, control)
    finally:
        probe.restore()


def _serve_and_check(cell, seed, seconds, traced, t_start, reg, wl, c, d,
                     mix, params, probe, sync, dev, marks, control):
    import torch
    from repro_torch.serve import CANCELLED, OK, Request

    engine = probe.engine

    # -- warm-up: the cell's prefill chunk and decode step, twice -----------
    rng = np.random.default_rng([seed % 2**64, 29])
    for _ in range(2):
        warm = [Request(prompt=rng.integers(0, d["V"], engine.prefill_chunk,
                                            dtype=np.int32), n_steps=3)]
        engine.run(warm)
    t_decode = min(s.wall for s in probe.warm_decodes)
    marks["warm-up"] = time.perf_counter()
    if traced and dev.type == "cuda":
        probe.profiler = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            acc_events=True)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]):
            engine.decode(np.zeros(engine.max_batch, np.int32),
                          np.zeros((engine.max_batch, engine.nb_table),
                                   np.int32),
                          np.zeros(engine.max_batch, np.int32))
        sync()

    # -- the trace and the window ---------------------------------------------
    horizon = wl["start_step"] + int(4 * seconds / max(t_decode, 1e-3)) + 100
    gen = traffic.generate(mix, seed, d["V"], horizon)
    reqs = traffic.to_requests(gen, cancel_at=horizon)
    probe.reqs = reqs
    probe.warm = False
    # what set-up made stays alive through the run: keep the collector
    # from walking it again and again while the window is timed
    gc.collect()
    gc.freeze()
    try:
        results, stats = engine.run(reqs)
    finally:
        gc.unfreeze()
    if probe.profiling:
        probe.profiler.stop()
        probe.profiling = False
    if probe.start is None or probe.close_step is None:
        raise RuntimeError(
            f"the window never {'opened' if probe.start is None else 'closed'}"
            f": {len(probe.decodes)} decode steps, horizon {horizon} ticks")
    last_arrival = max(r.arrival for r in reqs)
    idle_ticks = stats.ticks - stats.decode_steps
    if last_arrival <= probe.close_step + idle_ticks:
        raise RuntimeError(
            f"the trace ran out of arrivals (last at tick {last_arrival}) "
            f"before the window closed (decode step {probe.close_step})")
    if len(results) != len(reqs):
        raise RuntimeError("the engine returned fewer results than requests")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = None
    if probe.profiler is not None:
        summary = trace_mod.summarize(probe.profiler)
    probe.profiler = None
    router_rows = [r.cpu().numpy() for r in probe.router_rows]

    # -- free the program, then the output check ------------------------------
    probe.restore()
    del engine, stats
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    detail = check.served_gaps(reg, c, wl, params, gen, results, seed, dev)
    compared = {name: {"value": detail[name], "limit": limit}
                for name, limit in wl["check"]["limits"].items()}
    min_tokens = wl["check"]["min_tokens"]
    compared["tokens_compared"] = {"value": detail["tokens_compared"],
                                   "limit": min_tokens}
    correct = detail["tokens_compared"] >= min_tokens and all(
        v["value"] <= v["limit"] for k, v in compared.items()
        if k != "tokens_compared")

    # -- metrics ----------------------------------------------------------------
    run = Run(cell=cell, c=c, d=d, workload=wl, mix=mix, seconds=seconds,
              start=probe.start, end=probe.end, results=results, trace=gen,
              prefills=probe.prefills, decodes=probe.decodes,
              router_rows=router_rows, gmm=probe.gmm, device_trace=summary,
              registry=reg)
    metrics = {}
    for m in reg.metrics_of(cell, traced):
        if m["name"] == "setup_s":
            value = probe.start - t_start
        else:
            value = reg.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    admitted = window.admitted_in(results, probe.start, probe.end)
    failed = sum(1 for r in admitted
                 if not r.emit_times or r.status not in (OK, CANCELLED))
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(admitted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["compared"] = compared
    out["_check"] = detail
    names = list(marks) + ["ramp"]
    times = [t_start] + list(marks.values()) + [probe.start]
    out["_setup"] = {n: b - a for n, a, b in zip(names, times, times[1:])}
    if control:
        out["_control"] = check.control_gaps(reg, c, wl, params, gen,
                                             results, seed, dev)
    return out


def forbidden_modules(names=None) -> List[str]:
    """The top-level names among ``names`` (default: the loaded modules)
    that are JAX's or its package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    import torch
    reg = Registry()
    spec = next((w for w in reg.benchmark()["workloads"]
                 if w["name"] == a.workload), None)
    if spec is None:
        print(f"no cell named {a.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        print(f"{a.workload} needs {spec['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                   t_start=t_start, registry=reg)
    detail = out.pop("_check")
    setup = out.pop("_setup")
    found = forbidden_modules()
    if found:
        print(f"loaded modules the benchmark may not load: {found}",
              file=sys.stderr)
        return 4
    print(json.dumps({"setup_phases_s": setup}), file=sys.stderr)
    print(json.dumps({"check": detail}), file=sys.stderr)
    for name, v in out["compared"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0
