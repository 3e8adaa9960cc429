"""The 90th percentile, over the requests admitted in the window, of
the time from admission to the first token (prefill and its
interleaving with the other slots; queueing before admission is not
counted: the engine records no tick's wall time).  A first token that
comes after the window still counts."""

from h100bench import window


def read(run):
    v = window.ttfts(run.results, run.start, run.end)
    return window.percentile(v, 90) * 1e3 if v else None
