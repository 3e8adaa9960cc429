"""Valid rows over the rows launched, over the ``engine.prefill`` spans
of the window's whole recorded ticks (each chunk launches
``prefill_chunk`` rows; the rest of a prompt's last chunk is
padding)."""

from h100bench import spans


def read(run):
    t = spans.ticks(run)
    if t is None:
        return None
    chunks = t.named("engine.prefill")
    rows = sum(s.attrs["rows"] for s in chunks)
    if not rows:
        return None
    return 100.0 * sum(s.attrs["nv"] for s in chunks) / rows
