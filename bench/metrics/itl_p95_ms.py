"""The 95th percentile of every gap between consecutive tokens of a
request, both emitted inside the window."""

from h100bench import window


def read(run):
    v = window.gaps(run.results, run.start, run.end)
    return window.percentile(v, 95) * 1e3 if v else None
