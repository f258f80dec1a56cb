"""The MobileNet-v1 cell on the CPU, past the harness's look for a card, at
a small size (width 0.25, 32 x 32 images) on the kernels' plain versions:
sound it is correct; with one depthwise layer's output broken it is not.
On a card, the TF32 control at the cell's own size fails the limits."""
import pytest
import torch

from chipbench import bench, control
from chipbench.reference import mobilenet_v1
from chipbench.run import load_cell

CELL = "mobilenetv1-w1a4.bulk256"
SMALL = dict(width=0.25, img_hw=32)


def _run(trace=False):
    w, cfg, traffic, metrics = load_cell(CELL)
    traffic = dict(traffic, clients=16, max_batch=8)
    cell = bench.Cell(w["name"], dict(cfg, **SMALL), traffic, 1, metrics,
                      check_forwards=3, check_rows=4)
    return bench.run(cell, seed=2**31 + 5, seconds=0.5, trace=trace,
                     devices=["cpu"], t_process=0.0)


def test_the_reference_is_the_programs_spec():
    cfg = load_cell(CELL)[1]
    layers = mobilenet_v1.network(cfg)
    spec = bench.program_spec(cfg, layers)
    assert len(spec) == len(layers) == 28
    assert [s.groups for s in spec] == [l.groups for l in layers]
    assert sum(l.groups > 1 for l in layers) == 13


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"images_per_s", "p95_ms", "setup_s"}
    assert len(res["window"]["flips_by_layer"]) == 27


def test_the_new_readers_read_nothing_without_a_traced_slice():
    res = _run(trace=True)
    assert res["correct"]
    assert not {"dwconv_roofline", "executor.dwconv_ms"} & set(res["metrics"])


def test_a_broken_depthwise_layer_is_not_correct(monkeypatch):
    """The second depthwise layer's output mirrored left to right (a
    shift of a channel would leave the per-sample norm unmoved): the
    layer check sees it."""
    from repro_torch.kernels import ops

    orig, calls = ops.dwconv, [0]

    def broken(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls[0] += 1
        if calls[0] % 13 == 2:
            out = out.flip(2)
        return out

    monkeypatch.setattr(ops, "dwconv", broken)
    res = _run()
    assert not res["correct"]
    assert res["check"]["level_flips"]["value"] > 0.01


def _readers():
    return {n: mod for n, _, mod in load_cell(CELL)[3]}


def test_the_cell_reports_only_its_two_metrics():
    assert set(_readers()) == {"dwconv_roofline", "executor.dwconv_ms"}


def test_dwconv_roofline_charges_each_call_its_layers_bytes():
    """Two forwards' 26 calls in 2 ms: each call's bound is its layer's
    bytes (C channels in, the weights, float32 out) at 3.35 TB/s."""
    from chipbench import yardstick

    read = _readers()["dwconv_roofline"].read
    cfg = load_cell(CELL)[1]
    layers = mobilenet_v1.network(cfg)
    plan = [("fp", True)] + [("depthwise" if l.groups > 1 else "fused",
                              False) for l in layers[1:-1]] + [("fp", True)]
    ms = sum((256 * s.in_h * s.in_w * s.cout + 9 * s.cout
              + 4 * 256 * s.out_h * s.out_w * s.cout) / 3.35e9
             for s, l in zip(yardstick.layer_shapes(layers, 224, 256),
                             layers) if l.groups > 1)
    prof = dict(window_s=1.0, busy_s=[0.5], by_kernel={
        "void (anonymous namespace)::dwconv_kernel<1>(...)": [1.5e-3, 18],
        "void (anonymous namespace)::dwconv_kernel<2>(...)": [0.5e-3, 8],
        "void fused_qgemm_kernel<1>(...)": [9.0, 26]})
    ctx = dict(cfg=cfg, layers=layers, plan_layers=plan, replica_batch=256,
               profile=prof)
    assert read(ctx) == pytest.approx(100.0 * 2 * ms * 1e-3 / 2e-3)
    assert read(dict(ctx, profile=None)) is None
    no_calls = dict(prof, by_kernel={"void fused_qgemm_kernel<1>": [1, 1]})
    assert read(dict(ctx, profile=no_calls)) is None


def test_dwconv_span_reader_reads_the_window_and_nothing_else():
    """The sums of each forward's ``executor.dwconv`` spans, the median;
    None where the program records none (the parent's program)."""
    from repro_torch.launch.trace import Tracer

    read = _readers()["executor.dwconv_ms"].read
    tracer = Tracer(clock=lambda: 0.0)
    for k in range(3):           # three forwards of 13 spans, 1+k ms each
        with tracer.span("executor.plan"):
            for _ in range(13):
                tracer.add("executor.dwconv", 10.0 + k, 10.001 + k + k * 1e-3)
    ctx = dict(profile={"window_s": 1.0}, spans=[("round.submit", 0.0, 99.0)])
    import repro_torch.launch.trace as T

    saved, T.TRACER = T.TRACER, tracer
    try:
        assert read(ctx) == pytest.approx(13 * 2.0)
        empty = Tracer()
        T.TRACER = empty
        assert read(ctx) is None
    finally:
        T.TRACER = saved
    assert read(dict(ctx, profile=None)) is None


@pytest.mark.gpu
def test_control_fails_the_limits_at_the_cells_size(card):
    w, cfg, traffic, _ = load_cell(CELL)
    cell = bench.Cell(w["name"], cfg, traffic, w["chips"], [])
    for seed in (101, 102, 103):
        got = control.control_numbers(cell, seed, card)
        assert not bench.check.verdict(got, cfg["limits"]), got
