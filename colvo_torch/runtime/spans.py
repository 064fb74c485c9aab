"""Spans and counters: where a call of the program spends its host time.

``span(name, **attrs)`` is a context manager around one stage of a call
(a pair request, a VO chunk, a training step, a captured program's
replay); ``count(name, n)`` adds ``n`` to a cumulative counter. Each
thread keeps its own stack of open spans, so a span records the span it
opened inside (its parent) on the same thread.

A span records its name, its start and end on ``time.perf_counter_ns``,
its id, its parent's id (None at the top of its thread), the thread's id,
whether a torch profiler was recording when it started (``profiled``)
and its attrs, which carry the request's id where it has one: the call,
the chunk or the step index.

Recording is on unless ``enable(False)`` turns it off, and it writes
nothing out. Each finished span goes into one preallocated ring of
``RING_SIZE`` slots, the oldest overwritten first; counters are plain
integers. ``snapshot()`` reads both and ``clear()`` empties both. Off,
``span`` returns one shared no-op context and ``count`` returns at once:
neither allocates an object nor takes a lock.

``tally(name, n)`` adds to a counter that counts whether recording is on
or off and that ``clear()`` keeps: the kernels' launch counters
(``kernels.launch_counts``), which the CUDA graphs' replays and the
launch checks rely on. ``counters`` reads both kinds, and
``reset_counters`` drops both.

While a torch profiler records (``torch.autograd.profiler``'s flag), each
span also opens a ``torch.profiler.record_function`` range of its name,
so an exported trace carries the program's spans on the trace's clock.
Without a profiler no span calls it.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

# Every span of a 10 s run of each benchmark cell, with room: the pair
# cell, the busiest, leaves ~22,000 (5 a call).
RING_SIZE = 1 << 16

_perf_ns = time.perf_counter_ns
_get_ident = threading.get_ident


class Span(NamedTuple):
    """One finished span."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    thread: int
    profiled: bool
    attrs: dict

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class Snapshot(NamedTuple):
    """The ring's spans by start, and the counters."""

    spans: List[Span]
    counters: Dict[str, int]


class _Local(threading.local):
    top: Optional[int] = None  # the innermost open span's id on this thread


_enabled = True
_ring: list = [None] * RING_SIZE
_ids = itertools.count(1)  # next() on a count is atomic under the GIL
_writes = itertools.count()
_local = _Local()
_counters: Dict[str, int] = {}  # counted while recording
_tallies: Dict[str, int] = {}  # counted always, kept by clear()
_counters_lock = threading.Lock()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start", "profiled", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "_Span":
        self.id = next(_ids)
        self.parent = _local.top
        _local.top = self.id
        self.profiled = _autograd_profiler._is_profiler_enabled
        self.start = _perf_ns()
        if self.profiled:  # its start is stamped as it enters, as ours
            self._range = record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = _perf_ns()
        if self.profiled:
            self._range.__exit__(exc_type, exc, tb)
        _local.top = self.parent
        _ring[next(_writes) % RING_SIZE] = (self.name, self.start, end, self.id, self.parent,
                                            _get_ident(), self.profiled, self.attrs)
        return False


class _Noop:
    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP = _Noop()


def span(name: str, **attrs):
    """A context manager that records one span of ``name`` (see the module's
    docstring)."""
    if not _enabled:
        return _NOOP
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if not _enabled:
        return
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def tally(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, recording on or off."""
    with _counters_lock:
        _tallies[name] = _tallies.get(name, 0) + n


def counters(prefix: str = "") -> Dict[str, int]:
    """A copy of the counters whose name starts with ``prefix``."""
    with _counters_lock:
        return {k: v for d in (_counters, _tallies) for k, v in d.items() if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    """Drop the counters whose name starts with ``prefix``."""
    with _counters_lock:
        for d in (_counters, _tallies):
            for k in [k for k in d if k.startswith(prefix)]:
                del d[k]


def snapshot() -> Snapshot:
    """The spans in the ring, ordered by start, and a copy of the counters."""
    records = [r for r in list(_ring) if r is not None]
    spans = sorted((Span(*r) for r in records), key=lambda s: (s.start_ns, s.id))
    return Snapshot(spans, counters())


def clear() -> None:
    """Empty the ring and the counters that ``count`` adds to (the tallies
    stay)."""
    _ring[:] = [None] * RING_SIZE
    with _counters_lock:
        _counters.clear()


def enable(on: bool = True) -> None:
    """Turn recording on or off (for tests and for measuring its cost)."""
    global _enabled
    _enabled = bool(on)
