"""The harness's arithmetic and discovery, on synthetic inputs."""
import json
import types

import numpy as np
import pytest
import torch

from chipbench import bench, check, devtrace, yardstick
from chipbench.reference import svhn_cnn
from chipbench.run import BENCH, ROOT, load_cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
BULK, FAITHFUL = "svhn20-w1a4.bulk1024", "svhn20-w1a4-faithful.bulk1024"


def test_end_to_end_rate_tail_and_energy():
    # 100 requests: latencies 1..100 ms, over a 2 s window, 50 J drawn
    lat = np.arange(1, 101) / 1e3
    got = yardstick.end_to_end(lat[::-1], 2.0, 7.5, 50.0)
    assert got["images_per_s"] == (50.0, "images/s")
    assert got["p95_ms"] == (95.0, "ms")          # nearest rank, all requests
    assert got["images_per_J"] == (2.0, "images/J")
    assert got["setup_s"] == (7.5, "s")
    # no energy reading, or a counter that did not move: no energy metric
    assert "images_per_J" not in yardstick.end_to_end(lat, 2.0, 1.0, None)
    assert "images_per_J" not in yardstick.end_to_end(lat, 2.0, 1.0, 0.0)


@pytest.mark.parametrize("q,want", [(50, 3), (95, 5), (100, 5), (1, 1)])
def test_percentile_nearest_rank(q, want):
    assert yardstick.percentile([5, 1, 4, 2, 3], q) == want


def _shapes(batch=256):
    cfg = load_cell(BULK)[1]
    return yardstick.layer_shapes(svhn_cnn.network(cfg), 40, batch)


def test_layer_shapes_of_svhn20():
    s = _shapes()
    assert [(x.in_h, x.cin, x.k, x.out_h, x.cout) for x in s] == [
        (40, 3, 5, 40, 20), (40, 20, 3, 40, 20), (40, 20, 3, 40, 40),
        (20, 40, 3, 20, 40), (20, 40, 3, 20, 80), (10, 80, 3, 10, 80),
        (10, 80, 1, 10, 160), (10, 160, 1, 10, 10)]
    assert (s[1].m, s[1].kdim) == (256 * 1600, 180)


def test_kernel_work_hand_worked():
    s1, s6 = _shapes()[1], _shapes()[6]
    m = 256 * 40 * 40                      # 409,600 rows, K 180, N 20
    w = yardstick.kernel_work("conv_implicit", s1, 4, 1)
    assert w["ops"] == 2 * m * 180 * 20 + m * 180 == 3_022_848_000
    assert w["nbytes"] == 256 * 40 * 40 * 20 + 180 * 20 + 4 * m * 20
    w = yardstick.kernel_work("fused_qgemm", s6, 4, 1)
    assert w["ops"] == 2 * 25_600 * 80 * 160 + 25_600 * 80
    assert w["nbytes"] == 25_600 * 80 + 80 * 160 + 4 * 25_600 * 160
    # 180 = 6 words of 32 bits; 4 activation planes, 1 weight plane
    w = yardstick.kernel_work("quantize_pack", s1, 4, 1)
    assert w["nbytes"] == m * 180 + 4 * 4 * m * 6 and w["ops"] == 0
    w = yardstick.kernel_work("bitgemm_packed", s1, 4, 1)
    assert w["b1_ops"] == 2 * m * 20 * 180 * 4
    assert w["nbytes"] == 4 * (4 * m * 6 + 20 * 6 + m * 20)
    # the bound is the larger of the two times, in ms: bytes here
    t_ops = 3_022_848_000 / 1.979e15
    t_bytes = (256 * 40 * 40 * 20 + 180 * 20 + 4 * m * 20) / 3.35e12
    assert t_bytes > t_ops
    assert yardstick.kernel_bound_ms("conv_implicit", s1, 4, 1) == \
        pytest.approx(1e3 * t_bytes)
    with pytest.raises(ValueError):
        yardstick.kernel_work("attn_flash", s1, 4, 1)


def test_count_macs_is_the_papers_svhn20():
    """Width 20: 44,160,000 multiply-accumulates, the paper's ~80 MFLOPs
    a 40 x 40 image."""
    layers = svhn_cnn.network(load_cell(BULK)[1])
    assert yardstick.count_macs(layers, 40) == 44_160_000
    assert sum(s.macs for s in _shapes(1)) == 44_160_000


def _as_layers(spec):
    return [svhn_cnn.Layer(s.cin, s.cout, s.k, pool=s.pool, role=s.role,
                           stride=s.stride, fc=s.fc) for s in spec]


@pytest.mark.parametrize("net,img", [("alexnet", 224), ("lenet", 28),
                                     ("svhn", 40)])
def test_strided_and_fc_networks_count_as_the_program_does(net, img):
    """A strided first conv and fully connected layers at the end: the
    same multiply-accumulates as ``models.cnn.count_macs`` and the same
    output sides as the program's plan."""
    from repro_torch.api.reports import lenet_spec
    from repro_torch.core.plan import _plan_cnn_layers
    from repro_torch.core.quant import W1A8
    from repro_torch.models import cnn

    spec = {"alexnet": cnn.alexnet_spec, "lenet": lenet_spec,
            "svhn": lambda: cnn.svhn_cnn_spec(20)}[net]()
    layers = _as_layers(spec)
    want = cnn.count_macs(spec, img)
    assert yardstick.count_macs(layers, img) == want
    shapes = yardstick.layer_shapes(layers, img, 2)
    assert sum(s.macs for s in shapes) == 2 * want
    plan = _plan_cnn_layers(spec, W1A8, batches=(2,), img_hw=(img, img),
                            target="cuda")
    assert [(s.in_h, s.out_h, s.kdim, s.m) for s in shapes] == [
        (lp.in_h, lp.out_h, lp.k, 2 * lp.out_h * lp.out_w) for lp in plan]


def test_the_program_spec_is_held_to_the_reference_network():
    cfg = load_cell(BULK)[1]
    layers = svhn_cnn.network(cfg)
    assert len(bench.program_spec(cfg, layers)) == len(layers)
    strided = [layers[0]] + [svhn_cnn.Layer(**dict(
        vars(layers[1]), stride=2))] + layers[2:]
    with pytest.raises(ValueError):
        bench.program_spec(cfg, strided)
    fc = layers[:-1] + [svhn_cnn.Layer(**dict(vars(layers[-1]), fc=True))]
    with pytest.raises(ValueError):
        bench.program_spec(cfg, fc)


def test_work_is_the_same_whichever_engine_serves():
    """Both configurations describe one network: the same shapes, the same
    multiply-accumulates, the same bound a layer; the engine only picks
    which kernel's roofline a layer's bound is charged to."""
    (_, a, _, _), (_, b, _, _) = load_cell(BULK), load_cell(FAITHFUL)
    la, lb = svhn_cnn.network(a), svhn_cnn.network(b)
    assert la == lb and a["engine"] != b["engine"]
    assert yardstick.count_macs(la, 40) == yardstick.count_macs(lb, 40)
    assert (yardstick.layer_shapes(la, 40, 256)
            == yardstick.layer_shapes(lb, 40, 256))


def _profile(calls, secs, window=1.0):
    return dict(window_s=window, images=1024, busy_s=[0.5],
                by_kernel={"conv_implicit_kernel<8>": [secs, calls]},
                n_device_ops=10, spans=[])


def test_kernel_roofline_charges_each_call_its_layers_bound():
    cfg = load_cell(CELLS[0])[1]
    layers = svhn_cnn.network(cfg)
    plan = [("fp", True)] + [("implicit", False)] * 5 + [("fused", False),
                                                         ("fp", True)]
    shapes = yardstick.layer_shapes(layers, 40, 256)
    per_forward = sum(yardstick.kernel_bound_ms("conv_implicit", s, 4, 1)
                      for s in shapes[1:6])
    ctx = dict(cfg=cfg, layers=layers, plan_layers=plan, replica_batch=256,
               profile=_profile(calls=10, secs=0.02))
    # 10 calls = two forwards of five layers in 20 ms
    assert yardstick.kernel_roofline(ctx, "conv_implicit") == pytest.approx(
        100.0 * 2 * per_forward * 1e-3 / 0.02)
    assert yardstick.kernel_roofline(ctx, "bitgemm_packed") is None
    assert yardstick.kernel_roofline(dict(ctx, profile=None),
                                     "conv_implicit") is None


def test_kernel_label():
    assert yardstick.kernel_label("void conv_implicit_kernel<4, 1>(...)") \
        == "conv_implicit"
    assert yardstick.kernel_label("quantize_pack_tile_kernel") \
        == "quantize_pack"
    assert yardstick.kernel_label("x" * 90) == "x" * 70


def test_every_cell_is_found_by_name():
    for name in CELLS:
        w, cfg, traffic, metrics = load_cell(name)
        assert cfg["name"] == w["config"]
        assert traffic["clients"] % traffic["max_batch"] == 0
        assert traffic["max_batch"] % w["chips"] == 0
        want = {m["name"] for m in SPEC["per_layer"]
                if name in m.get("workloads", [name])}
        assert {n for n, _, _ in metrics} == want
        assert all(callable(mod.read) for _, _, mod in metrics)
    with pytest.raises(SystemExit):
        load_cell("no-such-cell")


def test_every_named_file_is_under_the_benchmark():
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("chipbench/configs/")
    for w in SPEC["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        ends = {e["name"] for e in SPEC["end_to_end"]}
        assert m["moves"] in ends


def _event(name, kind, t0, t1, dev=0, annotation=False):
    return types.SimpleNamespace(
        name=name, device_type=f"DeviceType.{kind}", device_index=dev,
        time_range=types.SimpleNamespace(start=t0 * 1e6, end=t1 * 1e6),
        is_user_annotation=annotation)


def test_summarize_busy_idle_and_annotations():
    ev = [_event("round.submit", "CPU", 0.0, 1.0, -1, True),
          _event("round.drain", "CPU", 1.0, 4.0, -1, True),
          _event("executor.forward", "CPU", 1.5, 2.0, -1, True),
          # the profiler's copy of a span on the device timeline
          _event("round.drain", "CUDA", 1.0, 4.0, 0, True),
          _event("conv_implicit_kernel", "CUDA", 1.6, 2.6),
          _event("round_kernel", "CUDA", 2.4, 3.0),
          _event("other_card_kernel", "CUDA", 0.5, 1.5, dev=1)]
    got = devtrace.summarize(ev, [0])
    assert got["window_s"] == pytest.approx(4.0)
    assert got["busy_s"] == [pytest.approx(1.4)]       # union of 1.6..3.0
    assert got["n_device_ops"] == 2
    assert got["by_kernel"]["conv_implicit_kernel"] == [pytest.approx(1.0), 1]
    idle = got["idle_by_span"]
    assert idle["round.submit"] == pytest.approx(1.0)
    assert idle["executor.forward"] == pytest.approx(0.1)   # 1.5 .. 1.6
    assert idle["round.drain"] == pytest.approx(1.5)         # 1.0-1.5, 3-4
    both = devtrace.summarize(ev, [0, 1])
    assert both["busy_s"][1] == pytest.approx(1.0)     # clipped to 0.5..1.5
    assert devtrace.summarize(ev[3:], [0]) == {}


def test_spans_only_while_on():
    t = iter(range(100))
    spans = devtrace.Spans(clock=lambda: float(next(t)))
    with spans.span("round.submit"):
        pass
    assert spans.take() == []
    spans.on = True
    with spans.span("round.submit"):
        pass
    assert spans.take() == [("round.submit", 0.0, 1.0)]


def test_capture_keeps_a_bounded_sample_of_forwards():
    cap = check.Capture(np.random.default_rng(0), forwards=3, rows=2,
                        a_bits=4)
    for r in range(40):
        cap.round = r
        x = torch.full((4, 1), float(r))
        cap.begin(x)
        cap.layer(x / 15)                  # level r
        cap.end()
    assert len(cap.kept) == 3 and cap.seen == 40
    for c in cap.kept:
        assert c["x"].shape == (4, 1) and (c["x"] == c["round"]).all()
        assert c["layers"][0].shape == (2, 1)
        assert (c["layers"][0] == c["round"]).all()
        assert c["last_hidden"].shape == (4, 1)
        assert (c["last_hidden"] == c["round"]).all()
    assert any(c["round"] >= 3 for c in cap.kept)    # later forwards too
    cap.open = False
    cap.begin(torch.zeros(4, 1))
    cap.end()
    assert cap.seen == 40


def test_the_traffic_carries_no_setting_of_the_check():
    """What the check keeps and the trace sees are the harness's own:
    a traffic file describes only what users send."""
    for name in CELLS:
        _, _, traffic, _ = load_cell(name)
        assert not {"check_rows", "check_forwards", "profile_rounds"} \
            & set(traffic)


def test_match_rows_finds_each_image_or_none():
    pool = torch.rand(8, 4, 4, 3)
    x = pool[[5, 2]].clone()
    x2 = x.clone()
    x2[1, 3, 3, 2] += 1.0                  # one pixel off: no image
    assert check.match_rows(x, pool).tolist() == [5, 2]
    assert check.match_rows(x2, pool).tolist() == [5, -1]
    twice = torch.cat([pool[:1], pool[:1]])  # an image the pool holds twice
    assert check.match_rows(pool[:1], twice).tolist() == [-1]


def test_reader_results_are_none_without_a_trace():
    _, _, _, metrics = load_cell(BULK)
    ctx = dict(profile=None, spans=[], service_s=np.array([]), chips=1)
    for name, _, mod in metrics:
        assert mod.read(ctx) is None, name


def test_harness_runner_passes_everything_through():
    class Inner:
        device = torch.device("cpu")

        def shape_key(self, p):
            return ("k",)

        def collate(self, payloads, pad_to):
            return ("c", pad_to)

        def replica(self, device):
            return self

        def forward(self, x, key=None):
            return x + 1

    spans = devtrace.Spans()
    cap = check.Capture(np.random.default_rng(0), 1, 1, 4)
    r = bench.HarnessRunner(Inner(), spans, cap)
    assert r.shape_key(0) == ("k",) and r.collate([], 4) == ("c", 4)
    spans.on = True
    assert r.replica("cpu").forward(torch.zeros(2)).tolist() == [1.0, 1.0]
    assert [n for n, _, _ in spans.take()] == ["executor.forward"]
    assert len(cap.kept) == 1
