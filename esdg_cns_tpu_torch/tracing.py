"""Spans at the port's layer boundaries: where the time of a step goes,
measured where the work happens.

``span(name)`` is a context manager placed at a few layer boundaries of
the main paths (the stepper's step and update, the cavity RHS's v(U),
exchanges and tail, the launches of K1, K2 and the projection); each
name is the module path of the code it wraps, e.g.
``timestepping.explicit.lsrk45.update`` or
``ops.fused_volume.euler_volume``.

Spans are off unless ``enable(True)`` was called or a torch profiler is
recording.  Off, ``span`` reads two flags and hands back one shared
no-op context: no profiler range, no clock, no store.  On, a span

  * under a recording profiler, enters ``torch.profiler.record_function``
    named after it: a ``user_annotation`` event on the profiler's
    timeline around the device operations it launched, so the
    profiler's own device trace times the span;
  * stamps the host clock (``time.perf_counter_ns``) at entry and exit;
  * after ``enable(True)``, when CUDA is initialised, records a pair of
    timing events at entry and exit on the stream that was current when
    the outermost span opened, from a pool (each outermost span first
    hands back the events the device has passed);
  * appends one ``Record`` to an in-memory store of at most ``CAP``
    records (the oldest dropped, ``dropped()`` counts them).

A recording profiler alone records no events: on the H100 a timing event
between two kernels of a stream holds the second back by about 3.1 us,
and the profiler already times each device operation.

Device times are resolved lazily: ``records()`` and ``summary()`` wait on
each span's exit event, then read the pair.  The span call counts are the
counters; the kernel wrappers' ``.launches`` integers (and K1's and
K2's ``.forms``, launches by form) stay beside them.

Spans nest by the order they are entered in one thread; the solvers run
on one host thread, and the store is not meant for several.

An operator's use::

    from esdg_cns_tpu_torch import tracing
    tracing.enable(True)
    q, _ = lsrk45(rhs, q, dt, steps)
    torch.cuda.synchronize()
    print(tracing.summary())
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

# the most records the store keeps; the oldest go first
CAP = 100_000


def _profiling():
    """Whether a torch profiler is recording (a module global PyTorch sets
    while one runs)."""
    return _autograd_profiler._is_profiler_enabled


class Record:
    """One span, and the context manager that times it: ``id``, ``name``,
    ``parent`` (the id of the span open around it, or None), host clock
    stamps in ns (``host_end_ns`` None while open) and the device time
    between its events (None without events)."""

    __slots__ = ("id", "name", "parent", "host_start_ns", "host_end_ns",
                 "_events", "_device_ms", "_range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._range = record_function(self.name) if _profiling() else None
        if self._range is not None:
            self._range.__enter__()
        s = _store
        self.id = s.next_id
        s.next_id += 1
        self.parent = s.open[-1].id if s.open else None
        self.host_end_ns = self._device_ms = self._events = None
        if s.enabled and torch.cuda.is_initialized():
            if self.parent is None:
                s.recycle()
                s.stream = torch.cuda.current_stream()
            self._events = s.pool.pop() if s.pool else (
                torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        if len(s.records) >= CAP:
            s.drop()
        s.records.append(self)
        s.open.append(self)
        self.host_start_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[0].record(s.stream)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(_store.stream)
            _store.pending.append(self)
        self.host_end_ns = time.perf_counter_ns()
        open_ = _store.open
        if open_ and open_[-1] is self:
            open_.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False

    @property
    def host_ms(self):
        """Host ms from entry to exit; None while open."""
        if self.host_end_ns is None:
            return None
        return (self.host_end_ns - self.host_start_ns) / 1e6

    @property
    def device_ms(self):
        """Device ms between the span's entry and exit events (waits for
        the exit event); None without events or while open."""
        if self._events is not None and self.host_end_ns is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._release()
        return self._device_ms

    def _release(self):
        """Hands the events of a closed record back to the pool."""
        if self._events is not None and self.host_end_ns is not None:
            _store.pool.append(self._events)
            self._events = None


class _Store:
    def __init__(self):
        self.enabled = False
        self.records = collections.deque()
        self.dropped = 0
        self.next_id = 0
        self.open = []
        self.pool = []
        self.stream = None
        # closed records whose events are not yet back in the pool
        self.pending = collections.deque()

    def recycle(self):
        """Resolves the closed records whose exit event the device has
        reached, oldest first, so their events go back to the pool."""
        pending = self.pending
        while pending:
            events = pending[0]._events
            if events is not None and not events[1].query():
                break
            pending.popleft().device_ms  # noqa: B018 -- resolves

    def drop(self):
        """Drops the oldest records down to below ``CAP``."""
        while len(self.records) >= CAP:
            self.records.popleft()._release()
            self.dropped += 1


_store = _Store()
_OFF = contextlib.nullcontext()


def span(name):
    """A context manager around one layer's work: a ``Record`` when spans
    are on (``enable(True)`` or a recording torch profiler), else a
    shared no-op context."""
    if _store.enabled or _profiling():
        return Record(name)
    return _OFF


def enable(on=True):
    """Turns spans on (or off) outside any profiler."""
    _store.enabled = bool(on)


def reset():
    """Empties the store and the drop count (spans open now still close
    normally; their records are not kept)."""
    for rec in _store.records:
        rec._release()
    _store.records.clear()
    _store.pending.clear()
    _store.dropped = 0


def dropped():
    """Records dropped from the store since the last ``reset`` (the store
    keeps the newest ``CAP``)."""
    return _store.dropped


def records():
    """The stored records, oldest first, with their device times
    resolved (waits for the device where a span's exit event is
    pending)."""
    out = list(_store.records)
    for rec in out:
        rec.device_ms  # noqa: B018 -- resolves the event pair
    return out


def summary():
    """Per span name: ``calls`` and ``host_ms`` over the closed stored
    records; ``device_calls``, ``device_ms`` and ``self_device_ms`` (the
    device time less the part the span's child spans cover) over those
    of them with device times, None where none has."""
    recs = [r for r in records() if r.host_end_ns is not None]
    child_ms = collections.defaultdict(float)
    for r in recs:
        if r.parent is not None and r.device_ms is not None:
            child_ms[r.parent] += r.device_ms
    out = {}
    for r in recs:
        s = out.setdefault(r.name, {"calls": 0, "host_ms": 0.0,
                                    "device_calls": 0, "device_ms": None,
                                    "self_device_ms": None})
        s["calls"] += 1
        s["host_ms"] += r.host_ms
        if r.device_ms is not None:
            s["device_calls"] += 1
            s["device_ms"] = (s["device_ms"] or 0.0) + r.device_ms
            s["self_device_ms"] = ((s["self_device_ms"] or 0.0)
                                   + r.device_ms - child_ms[r.id])
    return out
