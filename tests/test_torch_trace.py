"""The port's host tracer (``repro_torch.launch.trace``) and the spans the
serving engine, the CNN executor and the kernel loader record with it, on
a tiny CNN on the CPU."""
import gc

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import quant
from repro_torch.kernels import _lib
from repro_torch.launch.engine import CNNRunner, ServeEngine
from repro_torch.launch.trace import TRACER, Tracer
from repro_torch.models import cnn

SPEC = cnn.svhn_cnn_spec(4)        # 8 layers: 8 convolutions, 7 norms
HW = 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plan():
    params = cnn.init_cnn(torch.Generator().manual_seed(0), SPEC)
    return api.build(SPEC, quant.W1A4, params=params, img_hw=HW).compile(
        batch_hints=(4,)).plan


def _serve(plan, n=10, max_batch=4):
    """``n`` images through a fresh engine -> (results, the records they
    left)."""
    rs = np.random.RandomState(0)
    eng = ServeEngine(CNNRunner(plan), max_batch=max_batch)
    TRACER.clear()
    res = eng.serve([rs.uniform(0, 1, (HW, HW, 3)).astype(np.float32)
                     for _ in range(n)])
    return res, TRACER.records()


def _by_dispatch(recs, name):
    r = recs.where(name)
    return sorted(r.ident.tolist())


def test_each_bucket_records_its_engine_spans_and_wait(plan):
    res, recs = _serve(plan)
    dispatches = sorted({r.dispatch for r in res})
    assert len(dispatches) == 3                    # 4 + 4 + a ragged 2
    for name in ("engine.stage", "engine.harvest", "engine.harvest.wait",
                 "engine.ready_wait"):
        assert _by_dispatch(recs, name) == dispatches, name
    harvest, wait = recs.where("engine.harvest"), recs.where(
        "engine.harvest.wait")
    assert sorted(wait.parent.tolist()) == sorted(harvest.index.tolist())
    ready = recs.where("engine.ready_wait")
    assert (ready.parent == -1).all() and (ready.t1 >= ready.t0).all()
    drain = recs.where("engine.drain")
    assert len(drain) == 1
    assert set(harvest.parent.tolist()) == set(drain.index.tolist())
    closed = recs.where("engine.stage")
    assert np.isfinite(closed.t1).all() and (closed.t1 >= closed.t0).all()


def test_each_forward_records_its_layers_joined_to_its_results(plan):
    res, recs = _serve(plan)
    fwd = recs.where("executor.plan")
    assert sorted(fwd.ident.tolist()) == sorted({r.dispatch for r in res})
    conv, norm = recs.where("executor.conv"), recs.where("executor.norm")
    for i, d in zip(fwd.index.tolist(), fwd.ident.tolist()):
        assert (conv.parent == i).sum() == len(SPEC)
        assert (norm.parent == i).sum() == len(SPEC) - 1
        assert (conv.ident[conv.parent == i] == d).all()
        assert (norm.ident[norm.parent == i] == d).all()
    # a request's latency joins its bucket's spans by the dispatch number
    for r in res:
        (h,) = recs.where("engine.harvest").t0[
            recs.where("engine.harvest").ident == r.dispatch]
        assert r.t_start <= h <= r.t_done


def test_the_ring_keeps_the_newest_and_counts_what_it_dropped():
    t = iter(range(1000))
    tr = Tracer(capacity=4, clock=lambda: float(next(t)))
    gc.disable()                   # no collection's record in the count
    try:
        with tr.span("outer", 7):
            for _ in range(9):
                with tr.span("inner"):
                    pass
        recs = tr.records()
        assert tr.n == 10 and tr.dropped == 6
        assert recs.index.tolist() == [6, 7, 8, 9]
        assert recs.name.tolist() == ["inner"] * 4
        assert (recs.parent == 0).all() and (recs.ident == -1).all()
        assert tr.records(recs.t0[1], recs.t0[2]).index.tolist() == [7, 8]
    finally:
        tr.on = False
        gc.enable()


def test_a_tracer_that_is_off_records_nothing(plan):
    TRACER.on = False
    try:
        assert TRACER._on_gc not in gc.callbacks
        res, recs = _serve(plan)
        gc.collect()
        assert len(res) == 10 and len(TRACER.records()) == 0
    finally:
        TRACER.on = True
    assert TRACER._on_gc in gc.callbacks


def test_spans_are_user_annotations_under_the_profiler(plan):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(plan)
        gc.collect()
    names = {e.name for e in prof.events() if e.is_user_annotation}
    assert {"engine.drain", "engine.stage", "engine.harvest",
            "engine.harvest.wait", "executor.plan", "executor.conv",
            "executor.norm", "host.gc"} <= names
    assert "engine.ready_wait" not in names            # a wait, no range


def test_a_collection_leaves_a_host_gc_record():
    TRACER.clear()
    gc.collect()
    recs = TRACER.records().where("host.gc")
    assert 2 in recs.ident.tolist()
    assert (recs.t1 >= recs.t0).all()


FAKE_NVCC = """#!/bin/sh
while [ $# -gt 0 ]; do [ "$1" = -o ] && out=$2; shift; done
case "$out" in *bitgemm*) echo "error: planted in bitgemm"; exit 1;; esac
: > "$out"
"""


def test_builds_are_records_and_a_failed_build_raises(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("NVCC", str(nvcc))
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path / "kernels")
    before = TRACER.counters.get("kernels.builds", 0)
    TRACER.clear()
    with pytest.raises(RuntimeError, match="planted in bitgemm"):
        _lib.build_all(("quantpack", "bitgemm"))
    builds = TRACER.records().where("kernels.build")
    assert sorted(builds.ident.tolist()) == sorted(
        _lib.SOURCES.index(n) for n in ("quantpack", "bitgemm"))
    assert (builds.t1 >= builds.t0).all()
    assert TRACER.counters["kernels.builds"] == before + 1
    assert _lib._lib_path("quantpack").exists()
    assert not _lib._lib_path("bitgemm").exists()
    _lib.build_all(("quantpack",))                 # built: nothing to do
    assert TRACER.counters["kernels.builds"] == before + 1
