"""The one general traffic generator: a mix file's parameters -> a trace.

A mix (``bench/traffic/<mix>.json``) names a ``kind`` and its
parameters:

* ``"independent"``: single requests.  ``prompt`` and ``output`` are
  length distributions; ``rate_per_tick`` is the Poisson arrival rate in
  the engine's scheduler ticks.  ``initial`` requests arrive at tick 0
  as the requests in service at a random tick of the steady state would
  stand: their outputs are the residuals of ``output`` (a length drawn
  in proportion to itself, then a uniform share of it left), so the
  window need not wait for the slots to turn over once.
* ``"sessions"``: documents asked about several times.  Each session is
  one ``document`` followed by ``questions`` (an integer distribution)
  questions of ``question`` tokens, each appended to the document, with
  ``answer`` tokens to generate; the first question arrives with the
  session (Poisson, ``rate_per_tick`` sessions a tick, ``initial`` at
  tick 0), each further one ``followup_ticks`` after the previous one.
  The engine reaches its steady state over the cell's ``start_step``
  decode steps before the window opens.

A distribution is ``{"dist": "lognormal", "median", "sigma", "min",
"max"}``, ``{"dist": "loguniform", "min", "max"}`` or ``{"dist":
"uniform", "min", "max"}`` (integers, both ends included).

Every seed gets the same arrivals and the same sizes in the same
order; the seed draws every prompt token (and, in the harness, the
weights).  Each field draws from a fixed pool of ``POOL`` stratified
quantiles of its distribution, walked so that every aligned block of
``BLOCK`` consecutive draws spans the distribution (:class:`_Field`).
The arrival ticks are the running sum of exponential gaps taken so.
The window's
work is then the same for every seed, and a cell's runs spread by the
program alone: with the answers in an order drawn from the seed, eight
45-second windows of ``qwen2-7b.longdoc`` on one H100 read 64.0 to 74.2
tokens/s and 482 to 848 ms at the 95th percentile of the gaps between
tokens (a tick carries one or two 2048-row chunks).
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np

POOL = 1024             # stratified quantiles per field (a power of two)
BLOCK = 32              # draws that span the distribution (a power of two)
_BITS = POOL.bit_length() - 1


@dataclasses.dataclass
class TraceRequest:
    """What the generator makes of one request; :func:`to_requests` turns
    these into the program's ``Request`` objects."""

    prompt: np.ndarray
    n_steps: int
    arrival: int
    session: int = -1           # sessions: the session's index
    question: int = 0           # sessions: 0 for the document's first


def _bitrev(i: int) -> int:
    return int(f"{i:0{_BITS}b}"[::-1], 2)


_ORDER = [_bitrev(i) for i in range(POOL)]


def quantiles(spec: dict, n: int = POOL) -> np.ndarray:
    """``n`` stratified quantiles of a length distribution, as ints."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = spec["min"], spec["max"]
    kind = spec["dist"]
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in q])
        v = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    elif kind == "loguniform":
        v = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    elif kind == "uniform":
        v = lo + np.floor(q * (hi - lo + 1))
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


def residuals(lengths: np.ndarray, n: int = POOL) -> np.ndarray:
    """``n`` stratified quantiles of the tokens still to come of a
    request in service at a random tick, when requests ask for
    ``lengths``: a length ``L`` is in service for ``L`` steps, with
    ``L, L - 1, ..., 1`` left."""
    top = int(lengths.max())
    alive = np.array([(lengths >= r).sum() for r in range(1, top + 1)],
                     np.float64)
    cdf = np.cumsum(alive) / alive.sum()
    q = (np.arange(n) + 0.5) / n
    return np.searchsorted(cdf, q).astype(np.int64) + 1


def exponential_gaps(rate: float, n: int = POOL) -> np.ndarray:
    """``n`` stratified quantiles of an exponential gap of mean
    ``1 / rate`` ticks."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate


class _Field:
    """One field's draws: its pool walked in bit-reversed order, so that
    each aligned block of ``BLOCK`` draws takes one value from each of
    ``BLOCK`` equal bands of the distribution.  The blocks, and the draws
    within each, come in an order of the field's own (fixed, the same
    for every seed), so that two fields' n-th draws, such as a request's
    prompt and answer, are not the same quantile."""

    def __init__(self, pool: np.ndarray, field: int):
        rng = np.random.default_rng(field)
        self.pool = pool
        self.within = rng.permutation(BLOCK)
        self.blocks = rng.permutation(POOL // BLOCK)
        self.i = 0

    def next(self):
        b, j = divmod(self.i, BLOCK)
        self.i += 1
        k = self.blocks[b % len(self.blocks)] * BLOCK + self.within[j]
        return self.pool[_ORDER[k]]


def generate(mix: dict, seed: int, vocab: int, horizon: int
             ) -> List[TraceRequest]:
    """The requests of ``mix`` arriving before tick ``horizon``, in
    arrival order, drawn from ``seed``."""
    rng = np.random.default_rng([seed % 2**64, 17])
    kind = mix["kind"]
    if kind == "independent":
        return _independent(mix, rng, vocab, horizon)
    if kind == "sessions":
        return _sessions(mix, rng, vocab, horizon)
    raise ValueError(f"unknown traffic kind {kind!r}")


def _arrivals(mix: dict, horizon: int):
    """Arrival ticks: ``initial`` at 0, then Poisson at ``rate_per_tick``,
    until ``horizon``."""
    gaps = _Field(exponential_gaps(mix["rate_per_tick"]), 1)
    yield from [0] * mix.get("initial", 0)
    t = 0.0
    while True:
        t += gaps.next()
        if int(t) >= horizon:
            return
        yield int(t)


def _independent(mix, rng, vocab, horizon):
    prompt = _Field(quantiles(mix["prompt"]), 2)
    lengths = quantiles(mix["output"])
    output = _Field(lengths, 3)
    residual = _Field(residuals(lengths), 4)
    out = []
    for i, tick in enumerate(_arrivals(mix, horizon)):
        s = int(prompt.next())
        n = residual.next() if i < mix.get("initial", 0) else output.next()
        out.append(TraceRequest(
            prompt=rng.integers(0, vocab, s, dtype=np.int32),
            n_steps=int(n), arrival=tick))
    return out


def _sessions(mix, rng, vocab, horizon):
    doc = _Field(quantiles(mix["document"]), 5)
    n_q = _Field(quantiles(mix["questions"]), 6)
    q_len = _Field(quantiles(mix["question"]), 7)
    answer = _Field(quantiles(mix["answer"]), 8)
    follow = _Field(quantiles(mix["followup_ticks"]), 9)
    out = []
    for si, tick in enumerate(_arrivals(mix, horizon)):
        document = rng.integers(0, vocab, int(doc.next()), dtype=np.int32)
        t = tick
        for qi in range(int(n_q.next())):
            if qi:
                t += int(follow.next())
            question = rng.integers(0, vocab, int(q_len.next()),
                                    dtype=np.int32)
            n = int(answer.next())
            if t < horizon:
                out.append(TraceRequest(
                    prompt=np.concatenate([document, question]), n_steps=n,
                    arrival=t, session=si, question=qi))
    out.sort(key=lambda r: r.arrival)
    return out


def longest(mix: dict) -> int:
    """The most prompt tokens a request of ``mix`` can carry."""
    if mix["kind"] == "independent":
        return int(mix["prompt"]["max"])
    return int(mix["document"]["max"]) + int(mix["question"]["max"])


def to_requests(trace: List[TraceRequest], cancel_at: int):
    """The program's ``Request`` objects, each cancelled at ``cancel_at``
    at the latest."""
    from repro_torch.serve import Request
    return [Request(prompt=r.prompt, n_steps=r.n_steps, arrival=r.arrival,
                    cancel_at=cancel_at) for r in trace]
