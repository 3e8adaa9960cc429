"""The serve request/result schema (twin of ``repro.serve.api``).

* :class:`Request` — one serve request: prompt tokens, tokens to
  generate, arrival tick, optional deadline and cancel tick;
* :class:`RequestResult` — per-request outcome: generated tokens plus
  the scheduling record and terminal status;
* :class:`RunStats` — the run-level accounting; dict-compatible like
  the reference's (``stats["tokens"]``, ``.get``, ``.keys``,
  ``.as_dict``);
* :class:`ServeAPI` — the shared protocol both engines meet:
  ``run(trace, *, temperature=0.0, seed=0)`` returning
  ``(List[RequestResult], RunStats)``;
* :func:`as_requests` — a trace of :class:`Request` objects or, as the
  reference still takes them, legacy ``(prompt, n_steps[, arrival])``
  tuples, coerced with a one-shot ``DeprecationWarning``;
* :func:`sample` — the engines' token choice: greedy, or temperature
  sampling from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import (Any, Dict, Iterator, List, Optional, Protocol, Sequence,
                    Tuple, Union, runtime_checkable)

import numpy as np
import torch

__all__ = ["Request", "RequestResult", "RunStats", "ServeAPI", "as_requests",
           "sample"]


@dataclasses.dataclass
class Request:
    """``prompt`` (1-D int32 tokens), ``n_steps`` tokens to generate,
    ``arrival`` tick at which it may be admitted.  ``deadline`` is the
    tick it must have finished by (else ``TIMEOUT``, partial tokens
    kept); ``cancel_at`` the tick the client gives up (``CANCELLED``)."""

    prompt: np.ndarray
    n_steps: int
    arrival: int = 0
    deadline: Optional[int] = None
    cancel_at: Optional[int] = None


@dataclasses.dataclass
class RequestResult:
    """One request's outcome.  Times are ``time.perf_counter()``:
    ``arrival_time`` is the start of the tick at which the request became
    eligible (its ``arrival``; the sync engine, which has no ticks, leaves
    it 0.0), ``admit_time`` its admission, ``emit_times`` each token's.
    TTFT from arrival is ``emit_times[0] - arrival_time``; the wait
    before admission is ``admit_time - arrival_time``."""

    tokens: np.ndarray              # (n_steps,) generated tokens
    prompt_len: int
    arrival: int                    # tick the request became eligible
    admitted: int                   # tick it was admitted (-1: never)
    finished: int                   # tick its last token was emitted
    emit_times: List[float]         # perf_counter() per emitted token
    admit_time: float = 0.0         # perf_counter() at admission (TTFT base)
    prefix_blocks: int = 0          # pages taken from the prefix cache
    status: str = "OK"              # terminal state (serve.resilience)
    detail: str = ""                # human-readable reason for non-OK ends
    preemptions: int = 0            # times this request was evicted/requeued
    arrival_time: float = 0.0       # perf_counter() at its arrival tick


@dataclasses.dataclass
class RunStats:
    """Run-level accounting of one ``run(trace)``.  Fields an engine has
    no notion of stay 0 (the sync engine has no pool or scheduler clock;
    it reports ``batches`` instead)."""

    requests: int = 0
    tokens: int = 0                 # requested tokens actually emitted
    ticks: int = 0
    decode_steps: int = 0
    prefill_chunks: int = 0
    batches: int = 0                # sync bucket replay only
    prefix_blocks_reused: int = 0
    prefix_blocks_needed: int = 0
    prefix_hit_rate: float = 0.0
    occupancy_mean: float = 0.0
    occupancy_max: float = 0.0
    completed: int = 0              # requests that ended with status OK
    shed: int = 0                   # rejected by admission control
    timeouts: int = 0               # deadline crossed before completion
    cancelled: int = 0              # client cancel_at reached
    preemptions: int = 0            # evictions (incl. re-queues that ran OK)
    stalled_ticks: int = 0          # data-plane ticks lost to stall faults

    def __getitem__(self, key: str) -> Any:
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def keys(self) -> Iterator[str]:
        return iter(f.name for f in dataclasses.fields(self))

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@runtime_checkable
class ServeAPI(Protocol):
    """The shared serve protocol: replay a trace to completion."""

    def run(self, requests: Sequence[Union[Request, Tuple]], *,
            temperature: float = 0.0, seed: int = 0
            ) -> Tuple[List[RequestResult], RunStats]:
        ...


_WARNED: set = set()


def _warn_once(key: str, msg: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(msg, DeprecationWarning, stacklevel=3)


def as_requests(trace: Sequence[Union[Request, Tuple]]) -> List[Request]:
    """Validate a trace and normalise it in place: prompts flattened to
    1-D int32, ticks and counts to ints.  A legacy ``(prompt, n_steps[,
    arrival])`` tuple or list becomes a :class:`Request`; the first such
    coercion in a process warns (``DeprecationWarning``), as the
    reference's does."""
    reqs: List[Request] = []
    for i, r in enumerate(trace):
        if not isinstance(r, Request):
            if not isinstance(r, (tuple, list)) or not 2 <= len(r) <= 3:
                raise TypeError(
                    f"request {i}: expected a repro_torch.serve.Request or "
                    f"a legacy (prompt, n_steps[, arrival]) tuple, got "
                    f"{type(r).__name__}")
            _warn_once(
                "tuple-trace",
                "passing (prompt, n_steps[, arrival]) tuples to run() is "
                "deprecated; build repro_torch.serve.Request objects (e.g. "
                "via the repro_torch.serve.traces generators) instead")
            r = Request(*r)
        r.prompt = np.asarray(r.prompt, np.int32).reshape(-1)
        r.n_steps = int(r.n_steps)
        r.arrival = int(r.arrival)
        if r.deadline is not None:
            r.deadline = int(r.deadline)
        if r.cancel_at is not None:
            r.cancel_at = int(r.cancel_at)
        if r.n_steps < 1:
            raise ValueError(f"request {i}: n_steps={r.n_steps} < 1")
        reqs.append(r)
    return reqs


def sample(logits: torch.Tensor, temperature: float,
           gen: torch.Generator) -> torch.Tensor:
    """(B, V) or (V,) logits -> tokens, on the logits' device: the argmax
    when ``temperature <= 0``, else a draw from softmax(logits / T)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                             generator=gen).reshape(probs.shape[:-1])
