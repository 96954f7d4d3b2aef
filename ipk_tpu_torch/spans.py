"""Spans and counters of a build: the one writer of ``BuildResult.timings``.

A :class:`Recorder` lives for one build. ``recorder.span(name)`` is a
context manager that records the span's name, its start and end on
``time.perf_counter``, the thread it ran on and the span it ran under, and
on close adds its duration to ``timings[name]`` (or to ``timings[key]``).
``recorder.add(key, value)`` is a counter: it adds to ``timings[key]`` the
same way. The closed spans stay in ``recorder.spans``.

* Each thread keeps its own stack of open spans. A worker thread calls
  :meth:`Recorder.adopt` with a span of the thread that started it (its
  :meth:`Recorder.current`), and that span is the parent of the worker's
  outermost spans.
* A span's self time is its duration less the durations of its direct
  children on the same thread. A grouping span (``group=True``) only
  arranges its children; its self time, the time no span under it covers,
  adds to ``timings["untraced"]``.
* A device span (``device=`` a CUDA ``torch.device``) adds to its key the
  time between two CUDA events recorded on the device's current stream at
  its start and end, so the key holds the device's time for work the span
  ends by waiting for (a synchronize or a copy to the host). On the CPU the
  key takes the host's time, as for any span.
* While a ``torch.profiler`` is active, and only then, a span also opens
  ``torch.profiler.record_function("ipk.<name>")``: the program's spans then
  lie on the trace's one timeline beside the device's kernels and copies.
  Without a profiler a span costs two clock reads and a dict update.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler

__all__ = ["Recorder", "Span", "UNTRACED"]

#: the key that sums the self time of grouping spans
UNTRACED = "untraced"


def _profiling() -> bool:
    """Whether a ``torch.profiler`` is recording (on any thread)."""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False))


class Span:
    """One span of a build; a context manager opened by
    :meth:`Recorder.span`. ``start`` and ``end`` are ``perf_counter``
    seconds, ``thread`` the thread's ident, ``parent`` the enclosing span
    (None for a root), ``covered`` the seconds its direct children on the
    same thread took. A span on a CUDA device keeps the device, to time
    itself with events."""

    __slots__ = ("name", "key", "group", "thread", "parent", "start", "end",
                 "covered", "_recorder", "_device", "_events", "_marker")

    def __init__(self, recorder: "Recorder", name: str, key: str,
                 device: Optional[torch.device], group: bool):
        self.name, self.key, self.group = name, key, group
        self._recorder, self._device = recorder, device
        self.thread = 0
        self.parent: Optional[Span] = None
        self.start = self.end = self.covered = 0.0
        self._events = self._marker = None

    @property
    def duration(self) -> float:
        return self.end - self.start

    @property
    def self_time(self) -> float:
        return self.duration - self.covered

    def __enter__(self) -> "Span":
        rec = self._recorder
        self.parent = rec.current()
        self.thread = threading.get_ident()
        rec._stack().append(self)
        if _profiling():
            self._marker = torch.profiler.record_function("ipk." + self.name)
            self._marker.__enter__()
        if self._device is not None:
            stream = torch.cuda.current_stream(self._device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True), stream)
            self._events[0].record(stream)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        events, self._events = self._events, None
        if events is not None:
            begin, end, stream = events
            end.record(stream)
            end.synchronize()
        self.end = time.perf_counter()
        seconds = (begin.elapsed_time(end) / 1e3 if events is not None
                   else self.duration)
        if self._marker is not None:
            self._marker.__exit__(None, None, None)
            self._marker = None
        rec = self._recorder
        rec._stack().pop()
        parent = self.parent
        if parent is not None and parent.thread == self.thread:
            parent.covered += self.duration
        rec.spans.append(self)
        rec.add(self.key, seconds)
        if self.group:
            rec.add(UNTRACED, self.self_time)


class Recorder:
    """The spans and counters of one build (module docstring)."""

    def __init__(self):
        self.timings: Dict[str, float] = {}
        self.spans: List[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def span(self, name: str, *, key: Optional[str] = None,
             device: Optional[torch.device] = None,
             group: bool = False) -> Span:
        cuda = device is not None and device.type == "cuda"
        return Span(self, name, key or name, device if cuda else None, group)

    def add(self, key: str, value) -> None:
        with self._lock:
            self.timings[key] = self.timings.get(key, 0) + value

    def current(self) -> Optional[Span]:
        """The innermost span open on this thread (or the adopted one)."""
        stack = self._stack()
        return stack[-1] if stack else self._base()

    def adopt(self, parent: Optional[Span]) -> None:
        """Make ``parent`` the parent of this thread's outermost spans."""
        self._local.base = parent

    def _stack(self) -> List[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _base(self) -> Optional[Span]:
        return getattr(self._local, "base", None)
