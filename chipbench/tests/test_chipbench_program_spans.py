"""The readers of the program's own spans (``source: program_span``): each
reads the records of the measured window alone, and nothing where the run
has no traced slice or the program has no tracer."""
import gc
import sys
import time

import numpy as np
import pytest
import torch

from chipbench.run import load_cell

BULK = "svhn20-w1a4.bulk1024"
NAMES = ("engine.ready_wait_ms", "engine.stage_ms", "engine.harvest_ms",
         "executor.plan_ms", "executor.norm_ms", "host.gc_share")
PLANTED_S = 0.5          # each planted record outside the window


@pytest.fixture(scope="module")
def readers():
    metrics = {n: mod for n, _, mod in load_cell(BULK)[3]}
    return {n: metrics[n] for n in NAMES}


def _engine():
    from repro_torch import api
    from repro_torch.core import quant
    from repro_torch.launch.engine import CNNRunner, ServeEngine
    from repro_torch.models import cnn

    spec = cnn.svhn_cnn_spec(4)
    params = cnn.init_cnn(torch.Generator().manual_seed(0), spec)
    plan = api.build(spec, quant.W1A4, params=params, img_hw=8).compile(
        batch_hints=(4,)).plan
    return ServeEngine(CNNRunner(plan), max_batch=4)


def _plant(tracer, t0):
    """Records far longer than any of the window's, outside it."""
    for name in ("engine.stage", "engine.harvest", "executor.plan",
                 "host.gc"):
        for _ in range(8):
            tracer.add(name, t0, t0 + PLANTED_S)
    for _ in range(8):
        tracer.wait("engine.ready_wait", t0, t0 + PLANTED_S)
        with tracer.span("executor.plan"):
            tracer.add("executor.norm", t0, t0 + PLANTED_S)


def _round(engine, images, collect=False):
    clock = time.perf_counter
    t0 = clock()
    for x in images:
        engine.submit(x)
    t1 = clock()
    if collect:
        gc.collect()
    engine.drain()
    return [("round.submit", t0, t1), ("round.drain", t1, clock())]


@pytest.fixture(scope="module")
def run():
    """Three rounds of twelve images on the CPU; the window is the middle
    one, with a collection in it, and planted records lie on either side.
    -> (the ctx a traced run gives the readers, the window's records)."""
    from repro_torch.launch.trace import TRACER

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        engine = _engine()
        images = [np.random.RandomState(i).uniform(0, 1, (8, 8, 3))
                  .astype(np.float32) for i in range(12)]
        TRACER.clear()
        _round(engine, images)
        _plant(TRACER, time.perf_counter() - 100.0)
        spans = _round(engine, images, collect=True)
        _round(engine, images)
        _plant(TRACER, time.perf_counter() + 100.0)
    finally:
        torch.set_num_threads(n)
    lo, hi = spans[0][1], spans[-1][2]
    ctx = dict(profile=dict(window_s=1.0, busy_s=[0.5]), spans=spans,
               service_s=np.array([1e-3]), chips=1)
    return ctx, TRACER.records(lo, hi), hi - lo


def _dur(recs, name):
    return [b - a for n, a, b in zip(recs.name, recs.t0, recs.t1)
            if n == name]


def _children(recs, name, child):
    """Each ``name`` record's duration and its ``child`` records' sum."""
    out = {}
    for i, n, a, b in zip(recs.index, recs.name, recs.t0, recs.t1):
        if n == name:
            out[i] = [b - a, 0.0]
    for p, n, a, b in zip(recs.parent, recs.name, recs.t0, recs.t1):
        if n == child and p in out:
            out[p][1] += b - a
    return list(out.values())


def test_each_reader_reads_the_window_alone(readers, run):
    ctx, recs, wall = run
    assert len(recs.where("executor.plan")) == 3        # 3 buckets of 4
    want = {
        "engine.ready_wait_ms": 1e3 * np.median(
            _dur(recs, "engine.ready_wait")),
        "engine.stage_ms": 1e3 * np.median(_dur(recs, "engine.stage")),
        "engine.harvest_ms": 1e3 * np.median(
            [a - b for a, b in _children(recs, "engine.harvest",
                                         "engine.harvest.wait")]),
        "executor.plan_ms": 1e3 * np.median(_dur(recs, "executor.plan")),
        "executor.norm_ms": 1e3 * np.median(
            [b for _, b in _children(recs, "executor.plan",
                                     "executor.norm")]),
        "host.gc_share": 100.0 * sum(_dur(recs, "host.gc")) / wall,
    }
    for name, mod in readers.items():
        got = mod.read(ctx)
        assert got == pytest.approx(want[name], rel=1e-9), name
        assert 0.0 < got < 1e3 * PLANTED_S, name


def test_no_reading_without_a_traced_slice(readers, run):
    ctx = run[0]
    for name, mod in readers.items():
        assert mod.read(dict(ctx, profile=None)) is None, name
        assert mod.read(dict(ctx, spans=[])) is None, name


def test_no_reading_from_a_program_without_the_tracer(readers, run,
                                                      monkeypatch):
    """The parent of the tracer's commit runs the same readers."""
    monkeypatch.setitem(sys.modules, "repro_torch.launch.trace", None)
    for name, mod in readers.items():
        assert mod.read(run[0]) is None, name
