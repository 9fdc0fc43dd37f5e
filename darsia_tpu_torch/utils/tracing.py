"""Spans and counters of the port: where a call spends its time, and what
work it did there.

One mechanism for the whole package:

* :func:`span` opens a named interval at a layer boundary (the pipeline's
  stages, the W1 solver's Newton iterations and pressure solves, the
  kernels' build).  With tracing off it returns one shared object that
  does nothing: no allocation, no clock read, no CUDA event, no
  synchronisation.  Tracing is on after :func:`enable` (or inside
  ``with recording():``) and while a ``torch.profiler`` profile runs.  An
  open span then records its name, id, parent, thread, start and end
  (``time.perf_counter_ns``) and its attributes; under a profiler it also
  opens ``torch.profiler.record_function(name)``, so the span sits beside
  the kernels in the profiler's trace, on its clock.  Given a CUDA device,
  it records a start and an end CUDA event on the device's stream that is
  current when it opens, and never waits for them: once the end event has
  completed, a later span's opening reads the pair's elapsed time and
  returns the two events to a pool (creating CUDA events while many stay
  alive costs tens of microseconds each; recording a pooled one, a few).
* :func:`count` adds to a cumulative integer counter (always on, under one
  lock: worker threads launch too).  While a span is open on the calling
  thread, the count is also added to that innermost span's ``counts``, so
  a span carries the work done inside it.

Read :func:`spans` (start order; a span's ``device_ms`` waits for its end
event when read before it completed) and :func:`counter`.  The recorded
spans sit in a ring of the last :data:`CAPACITY`, so an operator tracing a
campaign of days holds bounded memory; :func:`reset` clears them.  The
profiler's own ``export_chrome_trace`` writes the spans out beside the
kernels.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Iterator, Optional

import torch

__all__ = [
    "CAPACITY",
    "Span",
    "count",
    "counter",
    "disable",
    "enable",
    "enabled",
    "recording",
    "reset",
    "span",
    "spans",
]

#: The most spans kept; older ones leave the ring as new ones open.
CAPACITY = 65536

_enabled = False
_lock = threading.Lock()
_counters: dict = {}
_ring: deque = deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()
#: ``torch.cuda.Stream`` objects by (device index, stream id): building one
#: costs several microseconds, looking its id up about one.
_streams: dict = {}
#: Timing events free for reuse, by device index.
_free_events: dict = {}
#: Closed spans whose events are still out, oldest first; ``_events_lock``
#: makes reading a pair's time and freeing it one step.
_pending: deque = deque()
_events_lock = threading.Lock()


class _Off:
    """The span of tracing off: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class Span:
    """One recorded interval: ``name``, ``id``, ``parent`` (the id of the
    span open around it on the same thread, or None), ``thread``,
    ``start_ns`` and ``end_ns`` (``time.perf_counter_ns``; ``end_ns`` None
    while open), ``attrs``, and ``counts`` (what :func:`count` added while
    it was the innermost open span).

    The host interval holds the span's own bookkeeping (the clock is read
    first on opening and last on closing), so a parent's time is its
    children's plus its own code's; the CUDA events hold the body only."""

    __slots__ = (
        "name", "id", "parent", "thread", "start_ns", "end_ns", "attrs", "counts",
        "_device", "_events", "_profiled", "_device_ms",
    )

    def __init__(self, name: str, device, attrs: dict) -> None:
        self.name = name
        self.attrs = attrs
        self._device = device

    def __enter__(self) -> "Span":
        self.start_ns = time.perf_counter_ns()
        self.end_ns = None
        self.id = next(_ids)
        self.thread = threading.get_ident()
        self.counts: dict = {}
        self._device_ms = None
        self._events = None
        self._profiled = None
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        _ring.append(self)
        device = None if self._device is None else torch.device(self._device)
        if device is not None and device.type == "cuda":
            index = torch.cuda.current_device() if device.index is None else device.index
            _collect()
            self._events = (_event(index), _event(index), _current_stream(index), index)
        if torch.autograd._profiler_enabled():
            self._profiled = torch.profiler.record_function(self.name)
            self._profiled.__enter__()
        if self._events is not None:
            self._events[0].record(self._events[2])
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record(self._events[2])
        if self._profiled is not None:
            self._profiled.__exit__(*exc)
            self._profiled = None
        _stack().pop()
        if self._events is not None:
            _pending.append(self)
        self.end_ns = time.perf_counter_ns()
        return False

    @property
    def host_ms(self) -> Optional[float]:
        """Host milliseconds from start to end (None while open)."""
        return None if self.end_ns is None else 1e-6 * (self.end_ns - self.start_ns)

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's two CUDA events on the stream:
        the device's work inside the span and any time the stream waited
        for the host there.  Waits for the end event if it has not completed
        yet; None without events or while open."""
        if self._events is not None and self.end_ns is not None:
            with _events_lock:
                self._resolve()
        return self._device_ms

    def _resolve(self) -> None:
        # Under ``_events_lock``: read the pair's time and free the pair.
        events = self._events
        if events is None:
            return
        start, end, _, index = events
        end.synchronize()
        self._device_ms = start.elapsed_time(end)
        self._events = None
        _free_events.setdefault(index, []).extend((start, end))


def _current_stream(index: int):
    """The current stream of the CUDA device ``index``."""
    key = (index, torch._C._cuda_getCurrentStream(index)[0])
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream(index)
    return stream


def _event(index: int):
    """A timing event for the CUDA device ``index``: a freed one, or new."""
    try:
        return _free_events[index].pop()
    except (KeyError, IndexError):
        return torch.cuda.Event(enable_timing=True)


def _collect(limit: int = 2) -> None:
    """Read the times of up to ``limit`` of the oldest closed spans whose
    end events have completed, freeing their events; never waits (another
    thread collecting, or an end event still ahead on its stream, ends it)."""
    if not _events_lock.acquire(blocking=False):
        return
    try:
        for _ in range(limit):
            if not _pending:
                return
            events = _pending[0]._events
            if events is not None and not events[1].query():
                return
            _pending.popleft()._resolve()
    finally:
        _events_lock.release()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def enabled() -> bool:
    """Whether a span opened now records: after :func:`enable`, or while a
    ``torch.profiler`` profile runs."""
    return _enabled or torch.autograd._profiler_enabled()


def span(name: str, device=None, **attrs):
    """A context manager around one interval named ``name``.

    ``device``: where the interval's work runs; a CUDA device adds the
    span's stream time (:attr:`Span.device_ms`).  ``attrs`` are kept with
    the span.  With tracing off (:func:`enabled` false) this returns one
    shared object that records nothing.
    """
    if not (_enabled or torch.autograd._profiler_enabled()):
        return _OFF
    return Span(name, device, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (under the lock), and to the
    innermost span open on this thread."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
    stack = getattr(_local, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def counter(name: str) -> int:
    """The counter ``name`` since the process started (0 if never counted)."""
    with _lock:
        return _counters.get(name, 0)


def spans() -> list:
    """The recorded spans (the last :data:`CAPACITY`), in start order."""
    return sorted(list(_ring), key=lambda s: s.start_ns)


def reset() -> None:
    """Forget the recorded spans (the counters keep counting)."""
    _ring.clear()


def enable() -> None:
    """Record spans from now on, with or without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a profiler runs."""
    global _enabled
    _enabled = False


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Tracing on inside the block, as it was after it."""
    global _enabled
    before = _enabled
    _enabled = True
    try:
        yield
    finally:
        _enabled = before
