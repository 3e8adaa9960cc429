"""The part of the device's idle time that the scheduler's host code
owns, as a share of the window's whole recorded ticks: from the end of
each host wait for the device (``engine.first_token``,
``engine.decode_wait``: the device's queue is empty after it) to the
start of the next engine step (``engine.prefill``, ``engine.decode``).
A lower bound on that part: the step's first kernel starts a little
after its span does."""

from h100bench import spans

WAITS = ("engine.first_token", "engine.decode_wait")
STEPS = ("engine.prefill", "engine.decode")


def read(run):
    t = spans.ticks(run)
    if t is None:
        return None
    idle, drained_at = 0, None
    for s in t.named(*WAITS, *STEPS):
        if s.name in WAITS:
            drained_at = s.end
        elif drained_at is not None:
            idle += s.start - drained_at
            drained_at = None
    return 100.0 * idle / t.length_ns
