"""The program's own spans and counters inside a run's window, for the
readers of the engine's per-layer metrics.

The program records them itself (``repro_torch.trace``): inside
``with trace.recording():``, and while a ``torch.profiler`` records,
which in a traced run on the card is the window's last
``trace_seconds``.  Only whole ticks count: an ``engine.tick`` span
recorded from its start to its end that lies inside ``[run.start,
run.end]``, with the spans opened directly inside it and the counter
records taken inside those.  :func:`ticks` gives None where nothing was
recorded, and for a program without the recorder (an older checkout),
so that a reader returns None there and raises nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

try:
    from repro_torch import trace
except ImportError:                 # a program that records no spans
    trace = None


@dataclasses.dataclass
class Ticks:
    ticks: list                     # the whole ticks, in order
    steps: list                     # the spans opened directly inside them
    start_ns: int                   # the first tick's start
    end_ns: int                     # the last tick's end

    @property
    def length_ns(self) -> int:
        return self.end_ns - self.start_ns

    def named(self, *names: str) -> list:
        """The steps of the given names, in opening order."""
        return [s for s in self.steps if s.name in names]

    def records(self, name: str, parents=("engine.prefill", "engine.decode")
                ) -> list:
        """The counter records ``name`` taken inside one of the steps
        named ``parents``."""
        ids = {s.id for s in self.named(*parents)}
        return [r for r in trace.records()
                if r.name == name and r.parent in ids]


def ticks(run) -> Optional[Ticks]:
    """The whole recorded ticks inside the window, or None."""
    if trace is None:
        return None
    lo, hi = run.start * 1e9, run.end * 1e9
    kept: List = []
    steps: Dict[int, list] = {}
    for s in trace.spans():
        if s.name == "engine.tick":
            if s.whole and lo <= s.start and s.end <= hi:
                kept.append(s)
                steps[s.id] = []
        elif s.parent in steps:
            steps[s.parent].append(s)
    if not kept:
        return None
    return Ticks(ticks=kept, steps=[c for t in kept for c in steps[t.id]],
                 start_ns=kept[0].start, end_ns=kept[-1].end)
