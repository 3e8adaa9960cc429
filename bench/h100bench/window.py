"""The window's arithmetic: what falls inside it, and the percentiles.

Times are the host clock (``time.perf_counter``) the engine stamps on
each request: ``admit_time`` when it took a slot, ``emit_times`` when
the host had each token.  The window is ``[start, end)``.
"""

from __future__ import annotations

import math
from typing import List, Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The ``p``-th percentile (0-100) by linear interpolation between
    the closest ranks, as ``numpy.percentile``'s default; NaN when
    there are no values."""
    xs = sorted(values)
    if not xs:
        return math.nan
    k = (len(xs) - 1) * p / 100.0
    lo = math.floor(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def tokens_in(results, start: float, end: float) -> int:
    """Tokens emitted inside the window, over all requests."""
    return sum(1 for r in results for t in r.emit_times if start <= t < end)


def admitted_in(results, start: float, end: float) -> list:
    """The requests admitted inside the window."""
    return [r for r in results
            if r.admitted >= 0 and start <= r.admit_time < end]


def ttfts(results, start: float, end: float) -> List[float]:
    """``emit_times[0] - admit_time`` of each request admitted in the
    window that emitted a token (the first token may come after the
    window: a late answer is late, not missing)."""
    return [r.emit_times[0] - r.admit_time
            for r in admitted_in(results, start, end) if r.emit_times]


def gaps(results, start: float, end: float) -> List[float]:
    """Every gap between consecutive tokens of a request, both emitted
    inside the window."""
    out = []
    for r in results:
        ts = [t for t in r.emit_times if start <= t < end]
        out += [b - a for a, b in zip(ts, ts[1:])]
    return out
