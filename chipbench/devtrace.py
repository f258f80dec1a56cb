"""The benchmark's spans around the calls into each layer of the program,
and the reduction of a ``torch.profiler`` slice to device busy time,
device operations by kernel and idle gaps by what the host was doing."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

# the benchmark's own spans, outermost first
SPAN_NAMES = ("round.submit", "round.drain", "engine.collate",
              "executor.forward")


class Spans:
    """Host spans ``(name, t0, t1)`` on the host clock, kept in memory while
    ``on``; inside a profiled slice each is also a profiler range."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.on = False
        self.profiling = False
        self.records: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        ctx = contextlib.nullcontext()
        if self.profiling:
            import torch

            ctx = torch.profiler.record_function(name)
        t0 = self.clock()
        with ctx:
            yield
        self.records.append((name, t0, self.clock()))

    def take(self) -> list[tuple[str, float, float]]:
        out, self.records = self.records, []
        return out


def _union(intervals) -> list[tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def _innermost(host, t: float) -> str:
    """The latest-started span that holds ``t``."""
    inner = [(s0, n) for n, s0, s1 in host if s0 <= t <= s1]
    return max(inner)[1] if inner else "between spans"


def summarize(events, devices: list[int]) -> dict:
    """Reduce a profiler's events over the benchmark's spans: the traced
    window (the first round's start to the last round's end), each
    device's busy seconds in it (the union of its operations), seconds and
    calls by device kernel, idle seconds by the innermost span the host was
    in, and the number of device operations.  Times in seconds."""
    host, dev = [], defaultdict(list)
    for e in events:
        kind = str(e.device_type).rsplit(".", 1)[-1]
        t0, t1 = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.name in SPAN_NAMES or getattr(e, "is_user_annotation", False):
            # a span's range, which the profiler also draws on the device
            # timeline: host time, never device work
            if kind == "CPU":
                host.append((e.name, t0, t1))
        elif kind == "CUDA" and t1 > t0:
            dev[e.device_index].append((t0, t1, e.name))
    rounds = [(a, b) for n, a, b in host if n.startswith("round.")]
    if not rounds:
        return {}
    lo, hi = min(a for a, _ in rounds), max(b for _, b in rounds)
    by_kernel = defaultdict(lambda: [0.0, 0])
    idle, busy, n_ops = defaultdict(float), [], 0
    for d in devices:
        ops = [(a, b, n) for a, b, n in dev.get(d, []) if b > lo and a < hi]
        n_ops += len(ops)
        for a, b, n in ops:
            by_kernel[n][0] += min(b, hi) - max(a, lo)
            by_kernel[n][1] += 1
        spans = _union(_clip([(a, b) for a, b, _ in ops], lo, hi))
        busy.append(sum(b - a for a, b in spans))
        edges = [lo] + [t for ab in spans for t in ab] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            cuts = sorted({a, b} | {t for _, s0, s1 in host for t in (s0, s1)
                                    if a < t < b})
            for c0, c1 in zip(cuts, cuts[1:]):
                idle[_innermost(host, 0.5 * (c0 + c1))] += c1 - c0
    return dict(window_s=hi - lo, busy_s=busy, n_device_ops=n_ops,
                by_kernel=dict(by_kernel), idle_by_span=dict(idle))
