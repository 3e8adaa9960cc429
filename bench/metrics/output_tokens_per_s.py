"""Generated tokens in the window over its wall time: every token any
request emitted inside it (host clock, when the host had the token)."""

from h100bench import window


def read(run):
    return window.tokens_in(run.results, run.start, run.end) / run.seconds
