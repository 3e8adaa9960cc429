"""p90 of each request's wait before admission (``admit_time -
arrival_time``: from the start of the tick it became eligible), over
the requests admitted in the window: the wait that ``ttft_p90_ms``
leaves out.  None for a program that stamps no arrival time."""

from h100bench import window


def read(run):
    admitted = window.admitted_in(run.results, run.start, run.end)
    if not admitted or not all(hasattr(r, "arrival_time") for r in admitted):
        return None
    return 1e3 * window.percentile(
        [r.admit_time - r.arrival_time for r in admitted], 90)
