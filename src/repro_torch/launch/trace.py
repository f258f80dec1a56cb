"""Host spans and counters of the port, on the host clock.

One tracer, :data:`TRACER`, records where the serving engine, the CNN
executor and the kernel loader spend the host's time:

- a **span** (``with TRACER.span(name):``) is a record of a name, its
  start and end on ``time.perf_counter``, the span that encloses it (its
  parent) and an identifier: the number of the dispatch it served
  (:meth:`Tracer.new_dispatch`), or -1;
- a **wait** (:meth:`Tracer.wait`) is an interval in which work waited
  and the host did other things (a closed bucket's wait for its forward):
  a record with no parent;
- a **collection** of the garbage collector is a ``host.gc`` record, its
  generation as its identifier, while the tracer is on;
- :attr:`Tracer.counters` holds named counts.

Spans nest on one stack: they are opened from the serving thread (the
engines are single-threaded), and a collection in another thread is
recorded as if inside the serving thread's innermost span.

Records go into a ring of fixed capacity, preallocated, so tracing adds
no Python object for the collector to walk; when the ring is full the
oldest records are overwritten and :attr:`Tracer.dropped` counts them.
Recording is on by default and costs one to two microseconds a span; with
``TRACER.on = False`` a span costs a call and one attribute test.  While a
``torch.profiler`` is recording, every span and collection is also a
``record_function`` range of the same name, on the timeline the device's
operations are on; waits are not.

:meth:`Tracer.records` returns the records that started in an interval as
arrays (:class:`Records`).
"""
from __future__ import annotations

import array
import contextlib
import dataclasses
import gc
import math
import time
from typing import Callable

import numpy as np
import torch.autograd.profiler as autograd_profiler
from torch.profiler import record_function

CAPACITY = 1 << 16


@dataclasses.dataclass(frozen=True)
class Records:
    """Records as arrays, one entry a record, in the order they were
    written (a ``host.gc`` record is written when its collection ends)."""
    index: np.ndarray    # the record's number in the tracer's life
    name: np.ndarray     # str
    t0: np.ndarray       # s
    t1: np.ndarray       # s; NaN while the span is open
    parent: np.ndarray   # the enclosing span's number, or -1
    ident: np.ndarray    # dispatch number, generation, library; or -1

    def __len__(self) -> int:
        return len(self.index)

    def where(self, name: str) -> "Records":
        keep = self.name == name
        return Records(*(getattr(self, f.name)[keep]
                         for f in dataclasses.fields(self)))


# the span of a tracer that is off
_OFF = contextlib.nullcontext()


class Tracer:
    """A ring of host records (see the module's docstring).  A span is the
    tracer itself as a context manager: spans close in the order ``with``
    nests them, so the innermost open span is the one an exit closes."""

    def __init__(self, capacity: int = CAPACITY,
                 clock: Callable[[], float] = time.perf_counter):
        self.capacity, self.clock = capacity, clock
        self._name = array.array("i", bytes(4 * capacity))
        self._t0 = array.array("d", bytes(8 * capacity))
        self._t1 = array.array("d", bytes(8 * capacity))
        self._parent = array.array("q", bytes(8 * capacity))
        self._ident = array.array("q", bytes(8 * capacity))
        self.names: list[str] = []
        self._ids: dict[str, int] = {}
        self.counters: dict[str, int] = {}
        self.n = 0              # records written in the tracer's life
        self._stack: list[int] = []   # numbers of the open spans
        self._ranges: list = []       # their profiler ranges, or None
        self.dispatch = -1      # the dispatch being served, if any
        self._dispatches = 0
        self._gc_start: tuple | None = None
        self._on = False
        self.on = True

    # -- switching -----------------------------------------------------------

    @property
    def on(self) -> bool:
        return self._on

    @on.setter
    def on(self, value: bool) -> None:
        value = bool(value)
        if value and not self._on:
            gc.callbacks.append(self._on_gc)
        elif self._on and not value:
            gc.callbacks.remove(self._on_gc)
            self._gc_start = None
        self._on = value

    # -- recording -----------------------------------------------------------

    def span(self, name: str, ident: int | None = None):
        """A context manager recording ``name`` from entry to exit, its
        identifier ``ident`` (default: :attr:`dispatch`)."""
        if not self._on:
            return _OFF
        rng = None
        if autograd_profiler._is_profiler_enabled:
            rng = record_function(name)
            rng.__enter__()
        # _write, inlined: this is the path every span takes
        i = self.n
        self.n = i + 1
        k = self._ids.get(name)
        if k is None:
            k = self._intern(name)
        s = i % self.capacity
        self._name[s] = k
        self._parent[s] = self._stack[-1] if self._stack else -1
        self._ident[s] = self.dispatch if ident is None else ident
        self._t1[s] = math.nan
        self._t0[s] = self.clock()
        self._stack.append(i)
        self._ranges.append(rng)
        return self

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        t1 = self.clock()
        i = self._stack.pop()
        if self.n - i <= self.capacity:
            self._t1[i % self.capacity] = t1
        rng = self._ranges.pop()
        if rng is not None:
            rng.__exit__(None, None, None)

    def wait(self, name: str, t0: float, t1: float, ident: int = -1) -> None:
        """Record that work waited from ``t0`` to ``t1``: no parent, no
        profiler range."""
        if self._on:
            self._write(name, t0, t1, ident, parent=-1)

    def add(self, name: str, t0: float, t1: float, ident: int = -1) -> None:
        """Record host work timed elsewhere (another thread, a child
        process), inside the innermost open span."""
        if self._on:
            self._write(name, t0, t1, ident)

    def _write(self, name: str, t0: float, t1: float, ident: int,
               parent: int | None = None) -> int:
        i = self.n
        self.n = i + 1
        k = self._ids.get(name)
        if k is None:
            k = self._intern(name)
        s = i % self.capacity
        self._name[s] = k
        self._t0[s], self._t1[s] = t0, t1
        self._parent[s] = (self._stack[-1] if self._stack else -1) \
            if parent is None else parent
        self._ident[s] = ident
        return i

    def _intern(self, name: str) -> int:
        k = self._ids[name] = len(self.names)
        self.names.append(name)
        return k

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            rng = None
            if autograd_profiler._is_profiler_enabled:
                rng = record_function("host.gc")
                rng.__enter__()
            self._gc_start = (self.clock(), rng)
        elif self._gc_start is not None:
            (t0, rng), self._gc_start = self._gc_start, None
            if rng is not None:
                rng.__exit__(None, None, None)
            self._write("host.gc", t0, self.clock(), info["generation"])

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` (counted whether on or off)."""
        self.counters[name] = self.counters.get(name, 0) + n

    def new_dispatch(self) -> int:
        """The next dispatch number, unique in the process's tracer."""
        self._dispatches += 1
        return self._dispatches - 1

    # -- reading -------------------------------------------------------------

    @property
    def dropped(self) -> int:
        """Records overwritten because the ring was full."""
        return max(self.n - self.capacity, 0)

    def records(self, t_lo: float = -math.inf,
                t_hi: float = math.inf) -> Records:
        """The records in the ring whose start lies in [t_lo, t_hi]."""
        index = np.arange(self.n - min(self.n, self.capacity), self.n)
        s = index % self.capacity
        t0 = np.frombuffer(self._t0, np.float64)[s]
        keep = (t0 >= t_lo) & (t0 <= t_hi)
        s = s[keep]
        names = np.asarray(self.names, dtype=str)
        return Records(index[keep], names[np.frombuffer(self._name, np.int32)[s]],
                       t0[keep], np.frombuffer(self._t1, np.float64)[s],
                       np.frombuffer(self._parent, np.int64)[s],
                       np.frombuffer(self._ident, np.int64)[s])

    def clear(self) -> None:
        """Forget every record, with no span open (counters and dispatch
        numbers stay)."""
        self.n = 0
        self._stack.clear()
        self._ranges.clear()


TRACER = Tracer()
