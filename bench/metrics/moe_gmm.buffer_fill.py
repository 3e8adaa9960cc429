"""Kept expert assignments over the expert buffers' rows (E x B x C,
the rows ``moe_gmm`` computes), over the ``moe.dispatch`` records taken
inside the engine steps of the window's whole recorded ticks.  Padded
prefill rows and slots that are not ACTIVE are routed too, and their
assignments count (``engine.prefill_row_fill`` shows the padding)."""

from h100bench import spans


def read(run):
    t = spans.ticks(run)
    if t is None:
        return None
    recs = t.records("moe.dispatch")
    rows = sum(r.attrs["E"] * r.attrs["B"] * r.attrs["C"] for r in recs)
    if not rows:
        return None
    return 100.0 * sum(int(r.value().sum()) for r in recs) / rows
