"""Registry of serve trace generators (copy of ``repro.serve.traces``).

The generators draw from numpy in exactly the reference's order, so a
seed gives the same request mix in both packages and the CPU tests can
replay one trace through both engines.  A trace generator has the
signature::

    fn(n_requests, vocab, seed=0, **kw) -> List[Request]
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

from repro_torch.serve.api import Request

__all__ = ["register_trace", "get_trace", "list_traces",
           "make_trace", "make_shared_trace", "make_longprompt_trace",
           "make_overload_trace"]

# the reference's defaults: requests are clamped to a 128-token engine
# bucket; the shared-prefix recipe fixes a 256-token system prompt
TRACE_MAX_LEN = 128
SHARED_PREFIX_LEN = 256

_REGISTRY: Dict[str, Callable[..., List[Request]]] = {}


def register_trace(name: str):
    """Decorator: register a trace generator under ``name``."""
    def deco(fn: Callable[..., List[Request]]):
        if name in _REGISTRY:
            raise ValueError(f"trace {name!r} is already registered")
        _REGISTRY[name] = fn
        return fn
    return deco


def get_trace(name: str) -> Callable[..., List[Request]]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown trace {name!r}; registered: {list_traces()}") from None


def list_traces() -> Sequence[str]:
    return sorted(_REGISTRY)


@register_trace("base")
def make_trace(n_requests: int, vocab: int, seed: int = 0,
               max_len: int = TRACE_MAX_LEN) -> List[Request]:
    """Ragged request mix: mostly short chat turns, a heavy tail of long
    generations, Poisson-ish arrivals in scheduler ticks."""
    rng = np.random.default_rng(seed)
    reqs = []
    tick = 0
    for i in range(n_requests):
        tick += int(rng.poisson(1))
        s = int(rng.integers(6, 72))
        if rng.random() < 0.2:                     # long-tail generations
            n = int(rng.integers(48, 96))
        else:
            n = int(rng.integers(4, 16))
        n = min(n, max_len - s)
        prompt = rng.integers(0, vocab, (s,)).astype(np.int32)
        reqs.append(Request(prompt=prompt, n_steps=n, arrival=tick))
    return reqs


@register_trace("shared_prefix")
def make_shared_trace(n_requests: int, vocab: int, seed: int = 0,
                      prefix_len: int = SHARED_PREFIX_LEN) -> List[Request]:
    """Shared-system-prompt recipe: one fixed ``prefix_len``-token prefix
    (page-aligned so its pages hash into the prefix index), a short
    unique tail per request, staggered arrivals."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, (prefix_len,)).astype(np.int32)
    reqs = []
    tick = 0
    for i in range(n_requests):
        tick += int(rng.poisson(1))
        tail = rng.integers(0, vocab,
                            (int(rng.integers(8, 48)),)).astype(np.int32)
        n = int(rng.integers(6, 20))
        reqs.append(Request(prompt=np.concatenate([prefix, tail]),
                            n_steps=n, arrival=tick))
    return reqs


@register_trace("overload")
def make_overload_trace(n_requests: int, vocab: int, seed: int = 0,
                        max_len: int = TRACE_MAX_LEN,
                        burst: int = 6,
                        deadline_frac: float = 0.5) -> List[Request]:
    """Offered load past capacity: requests arrive in bursts of
    ``burst`` per gap (far faster than a small engine drains them), and
    ``deadline_frac`` of them carry a deadline a few times their own
    service time — tight enough that sustained queueing blows it.  The
    graceful-degradation scenario: without shedding the queue and TTFT
    grow without bound; with a ``max_queue`` bound plus a deadline-aware
    policy the engine sheds doomed work and keeps the rest inside SLO."""
    rng = np.random.default_rng(seed)
    reqs = []
    tick = 0
    for i in range(n_requests):
        if i % burst == 0 and i:
            tick += int(rng.poisson(2))             # bursts, not a stream
        # draws scale with max_len so a 256-token bucket gets multi-page
        # requests (sequence growth past a 128-row page is what makes
        # pool exhaustion — and therefore preemption — reachable)
        s = int(rng.integers(6, max(7, min(120, max_len - 40))))
        n = int(rng.integers(8, 64))
        n = min(n, max_len - s)
        deadline = None
        if rng.random() < deadline_frac:
            # ~3-5x the request's own ticks of work: generous alone,
            # hopeless behind a deep queue
            deadline = tick + int((s // 32 + n) * rng.uniform(3.0, 5.0))
        prompt = rng.integers(0, vocab, (s,)).astype(np.int32)
        reqs.append(Request(prompt=prompt, n_steps=n, arrival=tick,
                            deadline=deadline))
    return reqs


@register_trace("long_prompt")
def make_longprompt_trace(n_requests: int, vocab: int,
                          seed: int = 0) -> List[Request]:
    """Long-prompt-under-load: every 4th request drags a multi-page
    prompt through admission while short decode-heavy requests stream —
    the monolithic-prefill stall lands on *their* token gaps."""
    rng = np.random.default_rng(seed)
    reqs = []
    tick = 0
    for i in range(n_requests):
        tick += int(rng.poisson(1))
        if i % 4 == 1:
            s = int(rng.integers(200, 340))
            n = int(rng.integers(4, 10))
        else:
            s = int(rng.integers(8, 48))
            n = int(rng.integers(12, 32))
        prompt = rng.integers(0, vocab, (s,)).astype(np.int32)
        reqs.append(Request(prompt=prompt, n_steps=n, arrival=tick))
    return reqs
