"""Port parity: the facade, engine dispatch, PIM simulation, serving, and
the port's import boundary.

* ``simulate`` is pure arithmetic over the plan's geometry, so the port
  must give the reference's floats EXACTLY for the same model.
* The ``cuda`` target routes as the reference's TPU target does; its
  engine table for svhn and AlexNet at batch 1 and 8 is pinned and must
  equal the TPU's.
* The port's ``ServeEngine`` must make batching invisible: each request's
  logits equal those of the same request served alone.
* ``repro_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
  package.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.core import plan as jplan_mod  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import plan as plan_mod  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.engine import (BucketBatcher, CNNRunner,  # noqa: E402
                                       QueueFull, Request, ServeEngine,
                                       _collate)
from repro_torch.models import cnn  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PIM_TARGETS = ("sot_mram", "imce", "reram", "cmos_asic")
MODELS = {"svhn": (jcnn.svhn_cnn_spec, cnn.svhn_cnn_spec, 40),
          "alexnet": (jcnn.alexnet_spec, cnn.alexnet_spec, 224)}

# the reference's TPU engine table (structure-only TPU plans): the same
# for W1A1, W1A4 and W1A8, at batch 1 and 8
GOLDEN = {
    "svhn": ["fp", "implicit", "implicit", "implicit", "implicit",
             "implicit", "fused", "fp"],
    "alexnet": ["fp", "implicit", "implicit", "implicit", "implicit",
                "fused", "fused", "fp"],
}


@pytest.mark.parametrize("model", ["svhn", "alexnet"])
@pytest.mark.parametrize("qname", ["w1a1", "w1a4", "w1a8"])
def test_cuda_engine_table_pinned_and_equal_to_tpu(model, qname):
    jspec, tspec, hw = MODELS[model]
    tp = plan_mod.compile_model(None, tspec(), quant.PAPER_CONFIGS[qname],
                                target="cuda", batch_hints=(1, 8), img_hw=hw)
    jp = jplan_mod.compile_model(None, jspec(), jquant.PAPER_CONFIGS[qname],
                                 backend="tpu", batch_hints=(1, 8), img_hw=hw)
    for b in (1, 8):
        got = [lp.engine_at(b) for lp in tp.layers]
        assert got == GOLDEN[model]
        assert got == [lp.engine_at(b) for lp in jp.layers]
    for tl, jl in zip(tp.layers, jp.layers):   # same geometry walk
        assert (tl.name, tl.in_h, tl.out_h, tl.k, tl.cin, tl.cout, tl.padding,
                tl.fp) == (jl.name, jl.in_h, jl.out_h, jl.k, jl.cin, jl.cout,
                           jl.padding, jl.fp)


def test_cuda_implicit_bound_is_the_kernels_shared_memory():
    from repro_torch.api.targets import get_target
    from repro_torch.kernels.conv_implicit import SMEM_LIMIT, smem_layout

    t = get_target("cuda")
    conv = ops.ConvShape(14, 14, 3, 3, 1, "SAME", batch=8)
    need, budget = t.implicit_smem(conv, 3 * 3 * 384, 384)
    assert need == smem_layout(14, 14, 384, 3, 3, 1, "SAME", 8,
                               384).smem_bytes
    assert budget == SMEM_LIMIT
    # a deep-K conv on a wide map whose staged rows overflow shared memory
    # even at the smallest pixel tile routes to the fused GEMM instead (and
    # forcing implicit is refused)
    wide = ops.ConvShape(16, 600, 3, 3, 1, "SAME", batch=1)
    k = 3 * 3 * 512
    assert t.implicit_smem(wide, k, 64)[0] > budget
    assert t.select_engine(wide.m, k, 64, 4, 1, wide) == "fused"
    ok, why = ops.engine_feasible("implicit", wide.m, k, 64, 4, 1, "cuda",
                                  wide)
    assert not ok and "shared memory" in why
    assert get_target("gpu") is t


@pytest.mark.parametrize("engine", ["faithful", "planes", "packed", "int8",
                                    "int8_planewise", "f32dot"])
def test_unported_engines_raise_plan_error(engine):
    """No dense engine is left unported: each engine the first slices
    refused now compiles on the ``cuda`` target as an explicit override,
    and where it is infeasible it still raises PlanError naming the
    layer."""
    q = dataclasses.replace(quant.W1A4, engine=engine)
    plan = plan_mod.compile_model(None, cnn.svhn_cnn_spec(8), q,
                                  target="cuda", img_hw=16)
    assert {lp.engine for lp in plan.layers if not lp.fp} == {engine}
    q = dataclasses.replace(quant.W1A4, a_bits=16, engine=engine)
    with pytest.raises(plan_mod.PlanError,
                       match=r"layer 1 \(conv1.*uint8 levels"):
        plan_mod.compile_model(None, cnn.svhn_cnn_spec(8), q, target="cuda",
                               img_hw=16)


def test_explicit_engine_overrides_and_infeasible_implicit():
    spec = cnn.svhn_cnn_spec(8)
    q = dataclasses.replace(quant.W1A4, engine="fused")
    plan = plan_mod.compile_model(None, spec, q, target="cuda", img_hw=16)
    assert {lp.engine for lp in plan.layers if not lp.fp} == {"fused"}
    assert {lp.engine_source for lp in plan.layers if not lp.fp} == {
        "override"}
    q = dataclasses.replace(quant.W1A4, engine="implicit")
    with pytest.raises(plan_mod.PlanError, match="1x1"):
        plan_mod.compile_model(None, spec, q, target="cuda", img_hw=16)
    with pytest.raises(plan_mod.PlanError, match="structure-only"):
        plan_mod.plan_forward(plan, torch.zeros((1, 16, 16, 3)))
    with pytest.raises(plan_mod.PlanError, match="simulate"):
        api.build(spec, quant.W1A4).compile(target="sot_mram")


@pytest.mark.parametrize("model", ["svhn", "alexnet"])
@pytest.mark.parametrize("qname", ["w1a1", "w1a4", "w1a8", "w2a2"])
@pytest.mark.parametrize("target", PIM_TARGETS)
def test_simulate_gives_the_reference_floats_exactly(model, qname, target):
    jspec, tspec, hw = MODELS[model]
    ref = japi.build(jspec(), jquant.PAPER_CONFIGS[qname], img_hw=hw).compile(
        target="cpu", verify=False).simulate(target=target)
    got = api.build(tspec(), quant.PAPER_CONFIGS[qname], img_hw=hw).compile(
        target="cuda").simulate(target=target)
    for f in ("target", "energy_uj", "latency_us", "fps", "macs", "row_ops",
              "bytes_moved", "area_mm2", "fps_per_mm2", "gops_per_w",
              "eff_per_mm2"):
        assert getattr(got, f) == getattr(ref, f), f
    assert len(got.layers) == len(ref.layers)
    for (gn, gc), (rn, rc) in zip(got.layers, ref.layers):
        assert gn == rn
        assert (gc.energy_pj, gc.cycles, gc.bytes_moved) == (
            rc.energy_pj, rc.cycles, rc.bytes_moved)
    tp = plan_mod.compile_model(None, tspec(), quant.PAPER_CONFIGS[qname],
                                img_hw=hw)
    jp = jplan_mod.compile_model(None, jspec(), jquant.PAPER_CONFIGS[qname],
                                 backend="cpu", img_hw=hw, verify=False)
    assert plan_mod.plan_cost_on(tp, target) == jplan_mod.plan_cost_on(
        jp, target)


def test_simulate_reproduces_the_paper_claims():
    """The same ratios the reference pins (tests/test_api.py): ~5.4x energy
    and ~9x speed over ReRAM, ~3x speed over IMCE, from one port plan."""
    compiled = api.build(cnn.svhn_cnn_spec(), quant.W1A4, img_hw=40).compile()
    proposed = compiled.simulate("sot_mram")
    ratios = proposed.vs(compiled.simulate("reram"))
    assert ratios["energy"] == pytest.approx(5.4, rel=0.15)
    assert ratios["speed"] == pytest.approx(9.0, rel=0.15)
    assert proposed.vs(compiled.simulate("imce"))["speed"] == pytest.approx(
        3.0, rel=0.15)
    with pytest.raises(plan_mod.PlanError, match="compute target"):
        compiled.simulate("cuda")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _svhn_compiled(qname="w1a4", width=16):
    params = cnn.init_cnn(torch.Generator().manual_seed(0),
                          cnn.svhn_cnn_spec(width))
    return api.build(cnn.svhn_cnn_spec(width), quant.PAPER_CONFIGS[qname],
                     params=params, img_hw=40).compile(batch_hints=(1, 8))


@pytest.mark.parametrize("qname", ["w1a4", "w1a8"])
def test_serve_engine_batched_equals_alone(qname):
    """12 requests at max_batch=8: one full bucket and one ragged one.  On
    the CPU every op of the serve forward is per-sample in a fixed order,
    so each result is bit-identical to the request served alone."""
    compiled = _svhn_compiled(qname)
    rs = np.random.RandomState(2)
    images = [rs.uniform(0, 1, (40, 40, 3)).astype(np.float32)
              for _ in range(12)]
    dep = compiled.serve(max_batch=8)
    batched = dep.predict(images)
    assert dep.stats == dict(dispatches=2, requests=12, padded_rows=0)
    for img, got in zip(images, batched):
        alone = dep.predict([img])[0]
        np.testing.assert_array_equal(got, alone)
    direct = compiled.forward(torch.from_numpy(np.stack(images[:8]))).numpy()
    np.testing.assert_array_equal(np.stack(batched[:8]), direct)


def test_serve_engine_pads_ragged_buckets_with_row_zero():
    compiled = _svhn_compiled()
    rs = np.random.RandomState(4)
    images = [rs.uniform(0, 1, (40, 40, 3)).astype(np.float32)
              for _ in range(3)]
    dep = compiled.serve(max_batch=8)
    res = dep.engine.serve(images)
    assert [r.padded for r in res] == [4, 4, 4] and res[0].batch == 3
    assert dep.stats["padded_rows"] == 1
    x = _collate(images, 4, np.float32)
    np.testing.assert_array_equal(x[3], x[0])


def test_collate_writes_into_a_given_buffer():
    rs = np.random.RandomState(5)
    images = [rs.uniform(0, 1, (6, 6, 3)) for _ in range(3)]    # float64
    out = np.full((4, 6, 6, 3), np.nan, np.float32)
    x = _collate(images, 4, np.float32, out=out)
    assert x is out
    np.testing.assert_array_equal(x, _collate(images, 4, np.float32))
    np.testing.assert_array_equal(x[3], x[0])


class _CountingPool:
    """A thread pool that counts what it is given."""

    def __init__(self, workers):
        from concurrent.futures import ThreadPoolExecutor

        self.pool, self.calls = ThreadPoolExecutor(workers), 0

    def submit(self, *args, **kwargs):
        self.calls += 1
        return self.pool.submit(*args, **kwargs)


@pytest.mark.parametrize("n,pad_to,chunk_bytes,parts", [
    (7, 8, 1 << 10, 4),        # ragged: 4 parts of 2, 2, 2 and 1 rows
    (3, 4, 1 << 9, 3),         # fewer rows than threads
    (7, 8, 1 << 20, 0),        # under two chunks: one stack, no thread
])
def test_collate_in_parts_on_threads_equals_one_stack(monkeypatch, n,
                                                       pad_to, chunk_bytes,
                                                       parts):
    from repro_torch.launch import engine

    monkeypatch.setattr(engine, "COLLATE_CHUNK_BYTES", chunk_bytes)
    rs = np.random.RandomState(7)
    images = [rs.uniform(0, 1, (8, 8, 3)) for _ in range(n)]   # float64
    workers = _CountingPool(engine.COLLATE_THREADS)
    out = np.full((pad_to, 8, 8, 3), np.nan, np.float32)
    x = _collate(images, pad_to, np.float32, out=out, workers=workers)
    assert x is out and workers.calls == parts
    np.testing.assert_array_equal(x, _collate(images, pad_to, np.float32))


def test_serve_engine_queue_and_deadline():
    compiled = _svhn_compiled()
    clock = [0.0]
    eng = ServeEngine(CNNRunner(compiled.plan), max_batch=4,
                      flush_deadline_s=0.01, max_pending=3,
                      clock=lambda: clock[0])
    img = np.zeros((40, 40, 3), np.float32)
    for _ in range(3):
        eng.submit(img)
    with pytest.raises(QueueFull):
        eng.submit(img)
    eng.pump()                      # deadline not reached: nothing runs
    assert eng.stats["dispatches"] == 0
    clock[0] = 0.02
    eng.pump()
    assert eng.stats == dict(dispatches=1, requests=3, padded_rows=1)
    assert [r.rid for r in eng.drain()] == [0, 1, 2]


def test_bucket_batcher_groups_by_key():
    b = BucketBatcher(max_batch=2, flush_deadline_s=1.0)
    assert b.add(Request(0, None, 0.0), "a", 0.0) is None
    assert b.add(Request(1, None, 0.0), "b", 0.0) is None
    full = b.add(Request(2, None, 0.0), "a", 0.5)
    assert full.key == "a" and [r.rid for r in full.requests] == [0, 2]
    assert b.pending() == 1 and b.take_expired(0.9) == []
    assert [x.key for x in b.take_expired(1.0)] == ["b"]


# ---------------------------------------------------------------------------
# import boundary
# ---------------------------------------------------------------------------

def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax_or_the_reference_package():
    pkg = ROOT / "src" / "repro_torch"
    files = sorted(pkg.rglob("*.py"))
    names = {f.relative_to(pkg).as_posix() for f in files}
    # the scan reaches every subpackage, the intermittency slice's too
    assert {"resilience/engine.py", "resilience/faults.py",
            "train/checkpoint.py", "pim/intermittent.py",
            "api/reports.py", "launch/plan_smoke.py"} <= names
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 49
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: {mod}"
