"""The device trace of a traced run's slice, read from ``torch.profiler``.

The profiler's Chrome trace is written to a temporary file, read and
deleted.  The traced window runs from the start of the first engine
step the slice annotated (``bench.prefill``, ``bench.decode``) to the
end of the last device operation or annotation.  ``busy_s`` is the
union of the device's kernels, copies and sets inside it; each idle gap
is labelled by what the host was doing at its middle: inside one of the
engine's steps, or outside them (the scheduler, the host's wait for the
tick's tokens).
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    ops: Dict[str, Tuple[float, int]]   # device op name -> (seconds, count)
    gaps: List[Tuple[str, float]]       # idle gaps, longest first

    def kernel_s(self, pattern: str) -> float:
        """Seconds of the device ops whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for name, (s, _) in self.ops.items() if rx.search(name))

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:10]
        return {"device_ops": [[_short(n), s] for n, (s, _) in top],
                "idle_gaps": [[label, s] for label, s in self.gaps[:10]]}


def _short(name: str) -> str:
    """A kernel's name without ``void`` and its parameter list."""
    name = name[5:] if name.startswith("void ") else name
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:160]


def summarize(profiler) -> Summary:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        profiler.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize_events(events)


def summarize_events(events) -> Summary:
    dev, notes = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", "")))
        elif cat == "user_annotation" and \
                str(e.get("name", "")).startswith("bench."):
            notes.append((ts, ts + dur, e["name"]))
    if not notes or not dev:
        raise RuntimeError("the trace holds no annotated engine step or no "
                           "device operation")
    notes.sort()
    w0 = notes[0][0]
    w1 = max(max(b for _, b, _ in dev), max(b for _, b, _ in notes))
    ops: Dict[str, Tuple[float, int]] = {}
    spans = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        s, n = ops.get(name, (0.0, 0))
        ops[name] = (s + (b - a) * 1e-6, n + 1)
        spans.append((a, b))
    spans.sort()
    busy, gaps, cur = 0.0, [], w0
    starts = [a for a, _, _ in notes]
    for a, b in spans:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if w1 > cur:
        gaps.append((cur, w1))
    labelled = []
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        inside = i >= 0 and notes[i][1] >= mid
        label = f"host in {notes[i][2]}" if inside \
            else "host outside the engine's steps"
        labelled.append((label, (b - a) * 1e-6))
    labelled.sort(key=lambda g: -g[1])
    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, ops=ops,
                   gaps=labelled)
