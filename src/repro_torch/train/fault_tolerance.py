"""Fault-tolerant training controller (twin of
``repro.train.fault_tolerance``): checkpoint and restart, failure
injection, straggler detection.

Every step runs inside a recovery boundary: a ``WorkerFailure`` (real or
injected) restores the latest checkpoint and replays from it.  The
asynchronous :class:`~repro_torch.train.checkpoint.Checkpointer` bounds
the lost work to ``ckpt_every`` steps.  A step slower than
``straggler_factor`` times the moving average of step times is flagged,
and ``on_straggler`` is called.

The replay is exact because a batch is a function of its step
(``SyntheticLM``) and the train step is a function of its inputs, which
it never writes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.train.checkpoint import Checkpointer, latest_step, restore

__all__ = ["WorkerFailure", "FailureInjector", "TrainController",
           "StragglerStats"]


class WorkerFailure(RuntimeError):
    """A (simulated) node failure surfaced to the control loop."""


@dataclasses.dataclass
class FailureInjector:
    """Raises WorkerFailure when ``step`` reaches each of ``at_steps``
    (once per entry), simulating node loss."""
    at_steps: Sequence[int] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.at_steps and step not in self._fired:
            self._fired.add(step)
            raise WorkerFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class StragglerStats:
    ema: float = 0.0
    beta: float = 0.9
    events: List[Dict] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float, factor: float) -> bool:
        if self.ema == 0.0:
            self.ema = dt
            return False
        slow = dt > factor * self.ema
        if slow:
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
        self.ema = self.beta * self.ema + (1 - self.beta) * dt
        return slow


class TrainController:
    def __init__(self, step_fn: Callable, ckpt_dir, *,
                 ckpt_every: int = 50, keep: int = 3,
                 injector: Optional[FailureInjector] = None,
                 straggler_factor: float = 3.0,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 max_restarts: int = 10):
        self.step_fn = step_fn
        self.ckpt = Checkpointer(ckpt_dir, every=ckpt_every, keep=keep)
        self.injector = injector
        self.stragglers = StragglerStats()
        self.straggler_factor = straggler_factor
        self.on_straggler = on_straggler
        self.max_restarts = max_restarts
        self.restarts = 0
        self.log: List[Dict] = []

    def _restore(self, state, fallback_state=None, fallback_step: int = 0):
        """(params, opt_state) and its step from the latest checkpoint.

        The pending save is joined BEFORE probing for the latest
        checkpoint: a save launched a step or two before the failure may
        not have made its atomic rename yet, and probing first would miss
        it and replay from the current state, applying updates twice.
        With no checkpoint on disk the replay starts from the state the
        run started from (``fallback_state`` at ``fallback_step``),
        never from the current mid-run state."""
        self.ckpt.wait()
        step = latest_step(self.ckpt.dir)
        if step is None:
            if fallback_state is None:
                fallback_state = state
            return fallback_state, fallback_step
        return restore(self.ckpt.dir, state)

    def run(self, state, data_iter_fn: Callable[[int], Any], n_steps: int,
            start_step: int = 0):
        """Run to ``n_steps``; ``state`` is (params, opt_state);
        ``data_iter_fn(step)`` returns that step's batch (resumable by
        construction).  Returns (state, metrics_log).  Each step's time
        runs to its loss on the host (``float(metrics["loss"])``), which
        waits for the device."""
        step = start_step
        initial_state, initial_step = state, start_step
        while step < n_steps:
            try:
                batch = data_iter_fn(step)
                if self.injector:
                    self.injector.check(step)
                t0 = time.time()
                params, opt_state, metrics = self.step_fn(state[0], state[1],
                                                          batch)
                loss = float(metrics["loss"])
                dt = time.time() - t0
                state = (params, opt_state)
                if self.stragglers.observe(step, dt, self.straggler_factor):
                    if self.on_straggler:
                        self.on_straggler(step, dt)
                self.log.append({"step": step, "loss": loss, "dt": dt})
                step += 1
                self.ckpt.maybe_save(step, state, extra={"step": step})
            except WorkerFailure as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                state, step = self._restore(state, initial_state,
                                            initial_step)
                self.log.append({"step": step, "event": "restart",
                                 "cause": str(e)})
        self.ckpt.maybe_save(step, state, force=True)
        self.ckpt.wait()
        return state, self.log
