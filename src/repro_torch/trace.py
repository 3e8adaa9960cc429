"""Spans and counters of the port's serving path, kept in memory on the
host's ``perf_counter`` clock, which the wall-clock stamps of
``torch.profiler`` follow up to an offset (and, while the OS slews the
wall clock, a rate a little off 1).

One recorder per process.  It records inside ``with recording():`` and
whenever a ``torch.profiler`` is recording (its state is read from
``torch.autograd.profiler._is_profiler_enabled``; where the attribute
is missing the profiler counts as off).  While it is off, every site
gets the shared no-op :data:`NOOP` back after that check: nothing is
allocated, no ``record_function`` is opened, no device work is added.
A span opened while the recorder is off stays unrecorded, even if
recording starts before it ends.

* A :class:`Span` is a name, a start and an end on
  ``time.perf_counter_ns()`` (the clock of ``time.perf_counter``), the
  id of the recorded span it was opened in, and a dict of attributes
  that the site fills only while recording::

      with trace.span("engine.prefill") as sp:
          if sp:
              sp.attrs.update(req=rid, pos=pos)
          ...

  While a profiler is recording, the span is also opened as
  ``torch.profiler.record_function(name)``, nested the same way, so it
  lands as a ``user_annotation`` in the exported Chrome trace on the
  timeline of the device's kernels.  ``whole`` tells whether the
  recorder was still on when the span closed: a span cut by the end of
  recording may lack the children opened after it.
* A :class:`Record` is a counter tagged with the recorded span it was
  taken in, with attributes, and it may hold a tensor (a device tensor
  the step computes anyway) with a reduction that runs only when
  :meth:`Record.value` is read, so taking it adds no kernel to the
  step::

      rec = trace.count("moe.dispatch")
      if rec:
          rec.attrs.update(E=E)
          rec.hold(used, reduce)

Spans and records share one ring of :data:`CAPACITY` entries, oldest
dropped first, read back in opening order by :func:`spans` and
:func:`records`.  The Chrome trace of a ``torch.profiler`` run is the
only export.  Nesting follows the order of the calls: record from one
thread.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["CAPACITY", "NOOP", "Record", "Span", "active", "clear", "count",
           "recording", "records", "span", "spans"]

CAPACITY = 1 << 16


class _Noop:
    """What a site gets while the recorder is off: false, and a context
    manager that does nothing."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP = _Noop()


class _State:
    __slots__ = ("ring", "stack", "depth", "ids")

    def __init__(self):
        self.ring: collections.deque = collections.deque(maxlen=CAPACITY)
        self.stack: List[int] = []        # ids of the open recorded spans
        self.depth = 0                    # open ``recording()`` blocks
        self.ids = itertools.count()


_state = _State()


def _profiling() -> bool:
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


def active() -> bool:
    """Whether the recorder is on: inside ``recording()``, or while a
    ``torch.profiler`` records."""
    return _state.depth > 0 or _profiling()


class Span:
    """One recorded span; times are ``perf_counter_ns`` (``end`` is None
    while it is open)."""

    __slots__ = ("name", "id", "parent", "start", "end", "attrs", "whole",
                 "_annotation")

    def __init__(self, name: str, parent: Optional[int]):
        self.name = name
        self.id = next(_state.ids)
        self.parent = parent
        self.start = self.end = None
        self.attrs: Dict[str, Any] = {}
        self.whole = False
        self._annotation = None

    def __enter__(self) -> "Span":
        _state.stack.append(self.id)
        # the annotation opens before ``start`` and closes after ``end``:
        # it holds the span whatever delays the host between the reads
        if _profiling():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        _state.stack.pop()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        self.whole = active()
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"start={self.start}, end={self.end}, attrs={self.attrs})")


class Record:
    """One counter record: taken at ``t`` (``perf_counter_ns``) inside
    the recorded span ``parent``."""

    __slots__ = ("name", "parent", "t", "attrs", "_tensor", "_reduce",
                 "_value")

    def __init__(self, name: str, parent: Optional[int]):
        self.name = name
        self.parent = parent
        self.t = time.perf_counter_ns()
        self.attrs: Dict[str, Any] = {}
        self._tensor = self._reduce = self._value = None

    def hold(self, tensor: torch.Tensor,
             reduce: Callable[[torch.Tensor], torch.Tensor]) -> None:
        """Keep a reference to ``tensor`` (no copy, no kernel), to be
        read through ``reduce`` when :meth:`value` is."""
        self._tensor, self._reduce = tensor, reduce

    def value(self):
        """``reduce(tensor)`` as a numpy array, computed on the first
        read (which waits for the device and lets the tensor go); None
        for a record that holds no tensor."""
        if self._tensor is not None:
            self._value = self._reduce(self._tensor).detach().cpu().numpy()
            self._tensor = self._reduce = None
        return self._value

    def __repr__(self) -> str:
        return (f"Record({self.name!r}, parent={self.parent}, t={self.t}, "
                f"attrs={self.attrs})")


def span(name: str):
    """A :class:`Span` to open with ``with``, or :data:`NOOP`."""
    if not active():
        return NOOP
    s = Span(name, _state.stack[-1] if _state.stack else None)
    _state.ring.append(s)
    return s


def count(name: str):
    """A :class:`Record` to fill (its ``attrs``, :meth:`Record.hold`), or
    :data:`NOOP`."""
    if not active():
        return NOOP
    r = Record(name, _state.stack[-1] if _state.stack else None)
    _state.ring.append(r)
    return r


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record inside the block, with or without a profiler."""
    _state.depth += 1
    try:
        yield
    finally:
        _state.depth -= 1


def spans() -> List[Span]:
    """The recorded spans in the ring, in opening order."""
    return [e for e in _state.ring if isinstance(e, Span)]


def records() -> List[Record]:
    """The counter records in the ring, in the order they were taken."""
    return [e for e in _state.ring if isinstance(e, Record)]


def clear() -> None:
    """Empty the ring (the open spans' nesting is kept)."""
    _state.ring.clear()
