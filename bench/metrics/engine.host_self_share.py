"""The scheduler's own host time, hidden behind the device's work or
not, as a share of the window's whole recorded ticks: each
``engine.tick`` span's duration less the spans opened directly inside
it (the engine's steps and the host's waits)."""

from h100bench import spans


def read(run):
    t = spans.ticks(run)
    if t is None:
        return None
    inside = sum(s.end - s.start for s in t.steps)
    ticks = sum(k.end - k.start for k in t.ticks)
    return 100.0 * (ticks - inside) / t.length_ns
