"""Spans of the program's own steps, on the device trace's clock.

    from repro_torch import obs

    with obs.span("extract", cols=k) as sp:
        ...
        sp.set(rows=n)            # attributes known only at the end

The recorder is on after :func:`enable` (until :func:`disable`) and
whenever a ``torch.profiler`` is recording.  Off, a span is a flag check
and one probe of the profiler: it records nothing, enters no
``record_function`` and builds nothing beyond its own keyword arguments.
On, each span records ``(name, span_id, parent_id, trace_id, start_ns,
end_ns, attrs)`` into a bounded in-memory buffer (:func:`records`,
:func:`clear`; the oldest records go first, and :func:`dropped` counts
them) and enters ``torch.profiler.record_function("repro_torch:" +
name)``, so a saved profiler trace shows the program's steps above its
kernels.

Stamps are ns since the epoch, the clock of ``time.time_ns()`` and of
the profiler's events, taken as ``perf_counter_ns()`` plus an offset read
once per process, so durations stay monotonic.  The parent is the span
open in the same thread, so spans of two threads never adopt each other;
a root span opens a new trace id that its descendants share.  A span
adds no synchronize: one around device work ends after that work's
result has been copied to the host.

The open span is kept in a ``threading.local``, not a ``ContextVar``:
NumPy 2 keeps its error state in a context variable, and while any other
one is set a structured ``argsort`` ran ~15% slower (NumPy 2.0.2), a
1.8M-triple compaction ~10%.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple

import torch

PREFIX = "repro_torch:"
MAX_RECORDS = 100_000


class Record(NamedTuple):
    """One finished span; stamps in ns since the epoch."""

    name: str
    span_id: int
    parent_id: int | None
    trace_id: int
    start_ns: int
    end_ns: int
    attrs: dict


_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
_profiling = torch.autograd._profiler_enabled
_enabled = False
_buffer: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
# ``.span``: (span_id, trace_id) of the span open in this thread
_open = threading.local()


def now_ns() -> int:
    """The recorder's clock: ns since the epoch, monotonic within a
    process."""
    return time.perf_counter_ns() + _OFFSET_NS


def enable() -> None:
    """Record every span until :func:`disable`."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def records() -> list[Record]:
    """The buffered spans, oldest first."""
    with _lock:
        return list(_buffer)


def dropped() -> int:
    """Spans dropped from the full buffer since the last :func:`clear`."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _buffer.clear()
        _dropped = 0


class _Off:
    """The span when the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "_key", "_outer", "_rf", "_t0")

    def __init__(self, name: str, attrs: dict) -> None:
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._t0 = now_ns()
        sid = next(_ids)
        parent = self._outer = getattr(_open, "span", None)
        self._key = (sid, None, sid) if parent is None else \
            (sid, parent[0], parent[1])
        _open.span = (sid, self._key[2])
        self._rf = torch.profiler.record_function(PREFIX + self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        global _dropped
        self._rf.__exit__(*exc)
        end = now_ns()
        _open.span = self._outer
        sid, parent_id, trace_id = self._key
        rec = Record(self.name, sid, parent_id, trace_id, self._t0, end,
                     self.attrs)
        with _lock:
            if len(_buffer) == MAX_RECORDS:
                _dropped += 1
            _buffer.append(rec)
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only once the step has run."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager around one step of the program (see the module
    docstring); ``as sp`` gives ``sp.set(**attrs)``."""
    if _enabled or _profiling():
        return _Span(name, attrs)
    return _OFF
