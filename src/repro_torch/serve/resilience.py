"""Graceful-degradation policies for the paged serve engine
(copy of ``repro.serve.resilience``, which is numpy-only host logic).

* **Terminal statuses** — every request ends in exactly one of
  :data:`OK` / :data:`TIMEOUT` / :data:`CANCELLED` / :data:`SHED` /
  :data:`PREEMPTED`, carried on ``RequestResult.status`` with a
  human-readable ``detail``.  ``PREEMPTED`` is terminal only when a
  request exceeds the engine's ``max_preemptions`` re-admission budget;
  an ordinarily preempted request re-queues as PENDING and recomputes.

* **Admission policies** — a pluggable :class:`AdmissionPolicy` decides,
  each tick, which *waiting* requests to shed before admission runs.
  :class:`FIFOPolicy` never sheds; :class:`QueueCapPolicy` bounds the
  arrival deque (newest arrivals shed first); :class:`DeadlineAwareShed`
  sheds requests whose deadline is already unreachable even on an idle
  engine (``tick + min_service_ticks - 1 > deadline``).  Policies are
  pure host logic over :class:`QueueEntry` views.

* **FaultPlan** — a deterministic schedule of injected faults:
  ``exhaust`` (seize free blocks from the allocator for a window),
  ``preempt`` (force victim preemptions), ``stall`` (the engine loses
  whole ticks of data-plane work while deadlines keep aging).  Effects
  are a pure function of the tick, so a plan replays identically, and
  ``PagedKVCache.check_invariants()`` can be asserted after every tick.

The scheduler's tick order (:meth:`PagedServeEngine.run`)::

    1. faults      release expired seizures; seize blocks for exhaust
                   faults firing now; note stall/forced-preempt effects
    2. cancel      cancel_at <= tick   -> CANCELLED (queued or in-flight)
    3. timeout     deadline  <  tick   -> TIMEOUT   (queued or in-flight)
    4. force-preempt   victims latest-admitted-first (fault-injected)
    5. shed        queue-cap bound, then the pluggable policy -> SHED
    6. admit       FIFO while a slot + the PROMPT block reservation fit
    7. prefill     one chunk per PREFILLING slot        [skipped if stalled]
    8. decode      grow each ACTIVE slot's block on page boundary —
                   alloc None preempts victims latest-admitted-first —
                   then one decode step for all actives [skipped if stalled]

Steps 6-8 are the data plane (a stalled tick skips them); steps 1-5 are
the control plane and always run, which is what makes deadlines honest
under stalls.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["OK", "TIMEOUT", "CANCELLED", "SHED", "PREEMPTED", "STATUSES",
           "QueueEntry", "AdmissionPolicy", "FIFOPolicy", "QueueCapPolicy",
           "DeadlineAwareShed", "Fault", "FaultPlan", "min_service_ticks"]

# -- terminal states --------------------------------------------------------

OK = "OK"                  # all requested tokens emitted
TIMEOUT = "TIMEOUT"        # deadline passed before the last token
CANCELLED = "CANCELLED"    # client gave up (Request.cancel_at)
SHED = "SHED"              # rejected by admission control, never ran
PREEMPTED = "PREEMPTED"    # evicted past the max_preemptions budget

STATUSES = (OK, TIMEOUT, CANCELLED, SHED, PREEMPTED)


def min_service_ticks(prompt_len: int, n_steps: int, chunk: int) -> int:
    """Ticks a request needs on an otherwise idle engine: one tick per
    prefill chunk (the last chunk's tick also emits the first token)
    plus one decode tick per remaining token.  The deadline-aware shed
    policy uses this as its feasibility bound — a request whose deadline
    precedes even this can never finish and is shed instead of admitted."""
    chunks = max(1, math.ceil(max(1, prompt_len) / chunk))
    return chunks + max(0, n_steps - 1)


# -- admission policies -----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QueueEntry:
    """One waiting request as the admission policies see it."""

    rid: int                    # index into the run's request list
    arrival: int
    deadline: Optional[int]
    prompt_len: int
    n_steps: int
    est_ticks: int              # min_service_ticks for this request
    waited: int                 # tick - arrival


class AdmissionPolicy:
    """Decides which waiting requests to shed before admission.

    ``shed(tick, queue)`` sees the waiting queue (arrival <= tick, FIFO
    order) and returns ``(rid, reason)`` pairs to reject this tick.  The
    base class sheds nothing.  Policies must be deterministic functions
    of their inputs — the fleet replica replays them tick-for-tick.
    """

    name = "fifo"

    def shed(self, tick: int, queue: Sequence[QueueEntry]
             ) -> List[Tuple[int, str]]:
        return []


class FIFOPolicy(AdmissionPolicy):
    """The pre-resilience baseline: wait forever, shed nothing."""


class QueueCapPolicy(AdmissionPolicy):
    """Bound the waiting queue at ``max_queue`` entries.

    Newest arrivals shed first: the requests already waiting keep their
    FIFO claim, and the rejection names the bound so operators can size
    it from the error alone.
    """

    name = "queue_cap"

    def __init__(self, max_queue: int):
        if max_queue < 1:
            raise ValueError(f"max_queue={max_queue} < 1")
        self.max_queue = int(max_queue)

    def shed(self, tick: int, queue: Sequence[QueueEntry]
             ) -> List[Tuple[int, str]]:
        excess = len(queue) - self.max_queue
        if excess <= 0:
            return []
        newest = sorted(queue, key=lambda e: (e.arrival, e.rid))[-excess:]
        return [(e.rid,
                 f"queue length {len(queue)} exceeds max_queue "
                 f"{self.max_queue} at tick {tick} (newest arrivals shed "
                 "first)") for e in newest]


class DeadlineAwareShed(AdmissionPolicy):
    """Shed waiting requests whose deadline is already unreachable.

    A request needing ``min_service_ticks`` cannot finish before
    ``tick + min_service_ticks - 1`` even on an idle engine; if that
    beats its deadline (plus ``slack`` grace ticks) it is shed *now*
    rather than admitted, run, and timed out — overload capacity goes
    to requests that can still meet their SLO.
    """

    name = "deadline_shed"

    def __init__(self, slack: int = 0):
        self.slack = int(slack)

    def shed(self, tick: int, queue: Sequence[QueueEntry]
             ) -> List[Tuple[int, str]]:
        out = []
        for e in queue:
            if e.deadline is None:
                continue
            finish = tick + e.est_ticks - 1
            if finish > e.deadline + self.slack:
                out.append((e.rid,
                            f"deadline {e.deadline} unreachable: earliest "
                            f"finish is tick {finish} (+{self.slack} slack) "
                            f"given {e.est_ticks} service ticks"))
        return out


def queue_entries(tick: int, waiting: Sequence[int], reqs,
                  chunk: int) -> List[QueueEntry]:
    """Policy view of the waiting queue (arrival <= tick), FIFO order.
    Shared by the engine and the fleet replica so both hand policies
    byte-identical inputs."""
    out = []
    for rid in waiting:
        r = reqs[rid]
        s = int(np.asarray(r.prompt).shape[0])
        out.append(QueueEntry(
            rid=rid, arrival=r.arrival, deadline=r.deadline,
            prompt_len=s, n_steps=r.n_steps,
            est_ticks=min_service_ticks(s, r.n_steps, chunk),
            waited=tick - r.arrival))
    return out


# -- deterministic fault injection ------------------------------------------

_FAULT_KINDS = ("exhaust", "preempt", "stall")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.

    ``kind``:

    * ``"exhaust"`` — seize ``n`` free blocks (``None`` = every free
      block) from the allocator at ``tick``; they return after
      ``duration`` ticks.  Seized blocks are real allocations, so the
      conservation invariant keeps holding while they are out.
    * ``"preempt"`` — force ``n`` victim preemptions at ``tick``
      (latest-admitted first, the same victim rule organic exhaustion
      uses).
    * ``"stall"`` — the engine loses ``duration`` whole ticks of
      data-plane work starting at ``tick``; deadlines keep aging.

    ``every``/``until`` make a fault periodic: it re-fires each
    ``every`` ticks from ``tick`` through ``until`` (inclusive;
    ``None`` = forever).
    """

    kind: str
    tick: int
    n: Optional[int] = None
    duration: int = 1
    every: Optional[int] = None
    until: Optional[int] = None

    def __post_init__(self):
        if self.kind not in _FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {_FAULT_KINDS}")
        if self.tick < 0:
            raise ValueError(f"fault tick {self.tick} < 0")
        if self.duration < 1:
            raise ValueError(f"fault duration {self.duration} < 1")
        if self.every is not None and self.every < 1:
            raise ValueError(f"fault every={self.every} < 1")

    def fires_at(self, tick: int) -> bool:
        if self.every is None:
            return tick == self.tick
        if tick < self.tick or (self.until is not None
                                and tick > self.until):
            return False
        return (tick - self.tick) % self.every == 0


class FaultPlan:
    """A deterministic, replayable schedule of injected faults.

    Effects are a pure function of the tick — the plan holds no run
    state — so one plan drives the real engine and the fleet replica
    identically, and re-running a plan reproduces the failure
    bit-for-bit.  ``seed`` only matters to :meth:`random`, which draws
    a reproducible chaos schedule from it.
    """

    def __init__(self, seed: int = 0, faults: Sequence[Fault] = ()):
        self.seed = int(seed)
        self.faults = tuple(faults)
        for f in self.faults:
            if not isinstance(f, Fault):
                raise TypeError(f"FaultPlan faults must be Fault objects, "
                                f"got {type(f).__name__}")

    def seizures(self, tick: int) -> List[Fault]:
        """Exhaust faults firing this tick."""
        return [f for f in self.faults
                if f.kind == "exhaust" and f.fires_at(tick)]

    def forced_preemptions(self, tick: int) -> int:
        """Victim count to force-preempt this tick."""
        return sum((f.n or 1) for f in self.faults
                   if f.kind == "preempt" and f.fires_at(tick))

    def stalled(self, tick: int) -> bool:
        """True when any stall fault's window covers this tick."""
        for f in self.faults:
            if f.kind != "stall":
                continue
            if f.every is None:
                if f.tick <= tick < f.tick + f.duration:
                    return True
            else:
                if tick >= f.tick and (f.until is None or tick <= f.until) \
                        and (tick - f.tick) % f.every < f.duration:
                    return True
        return False

    @classmethod
    def random(cls, seed: int, *, horizon: int, n_faults: int = 6,
               max_seize: int = 4) -> "FaultPlan":
        """A reproducible chaos schedule: ``n_faults`` faults of random
        kind/tick/size drawn from ``seed`` over ``[0, horizon)`` ticks.
        The chaos suite sweeps seeds; any failure names its seed, so
        every red run replays exactly."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            kind = _FAULT_KINDS[int(rng.integers(0, len(_FAULT_KINDS)))]
            tick = int(rng.integers(0, max(1, horizon)))
            if kind == "exhaust":
                faults.append(Fault(kind, tick,
                                    n=int(rng.integers(1, max_seize + 1)),
                                    duration=int(rng.integers(1, 6))))
            elif kind == "preempt":
                faults.append(Fault(kind, tick,
                                    n=int(rng.integers(1, 3))))
            else:
                faults.append(Fault(kind, tick,
                                    duration=int(rng.integers(1, 4))))
        return cls(seed=seed, faults=faults)

    def __repr__(self) -> str:
        return f"FaultPlan(seed={self.seed}, faults={list(self.faults)})"
