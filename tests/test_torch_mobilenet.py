"""MobileNet-v1 served by the port: the spec walk, the plan, the depthwise
kernel (``kernels/dwconv.py``, ``csrc/dwconv.cu``) and the executor
against the plain reference (``reference/mobilenet_v1.py``).

The CPU tests run the kernels' plain versions on one torch thread.  The
``gpu`` tests hold the kernel to its plain version bit for bit at the 13
depthwise layers' shapes, and a served forward to the oracle; this file
does not import JAX.  Run the card's share with
``python -m pytest -q -m gpu tests/test_torch_mobilenet.py``.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core import plan as P  # noqa: E402
from repro_torch.core.quant import W1A4, QuantConfig  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.dwconv import dwconv, dwconv_plain  # noqa: E402
from repro_torch.kernels.norm_act import plan_for  # noqa: E402
from repro_torch.launch.trace import TRACER  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from reference import mobilenet_v1 as R  # noqa: E402

# each layer's output side at 224 x 224 (TF-slim's maps)
SIDES = [112, 112, 112, 56, 56, 56, 56, 28, 28, 28, 28, 14, 14,
         14, 14, 14, 14, 14, 14, 14, 14, 14, 14, 7, 7, 7, 7, 7]
# the depthwise layers at width 1.0: (input side, channels, stride)
DEPTHWISE = [(112, 32, 1), (112, 64, 2), (56, 128, 1), (56, 128, 2),
             (28, 256, 1), (28, 256, 2), (14, 512, 1), (14, 512, 1),
             (14, 512, 1), (14, 512, 1), (14, 512, 1), (14, 512, 2),
             (7, 1024, 1)]
SMALL = dict(width=0.25, classes=1000, in_channels=3, w_bits=1, a_bits=4,
             first_last_fp=True)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    return torch.device("cuda")


def _params(layers, seed: int, device="cpu") -> list[dict]:
    """Seeded float params in the harness's layout (HWIO ``w``, ``b``,
    ``g``, ``beta``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for l in layers:
        def r(*shape):
            return torch.randn(shape, generator=gen, device=device)
        out.append(dict(w=r(l.k, l.k, l.cin, l.cout) / math.sqrt(
            l.k * l.k * l.cin), b=0.1 * r(l.cout), g=1 + 0.1 * r(l.cout),
            beta=0.1 * r(l.cout)))
    return out


# ---------------------------------------------------------------------------
# the spec and the plan
# ---------------------------------------------------------------------------

def test_spec_walk_counts_the_published_network():
    """Howard et al. give 569 M multiply-adds and 4.2 M parameters: 28
    layers, 4,221,032 weights and biases, 568,740,352 multiply-accumulates
    with the classifier after the pool; as served (the classifier over the
    7x7 map) 49x the classifier's."""
    spec = cnn.mobilenet_v1_spec()
    assert len(spec) == 28 and sum(s.groups > 1 for s in spec) == 13
    assert cnn.count_params(spec) + sum(s.cout for s in spec) == 4_221_032
    served = cnn.count_macs(spec, 224)
    assert served == 617_892_352
    assert served - 48 * 1024 * 1000 == 568_740_352
    assert spec == cnn.mobilenet_v1_spec(1.0, 1000)
    assert [(s.cin, s.cout) for s in cnn.mobilenet_v1_spec(0.25)[:3]] == [
        (3, 8), (1, 8), (8, 16)]


def test_groups_other_than_depthwise_are_refused_naming_the_layer():
    spec = [cnn.ConvSpec(3, 8, 3, role="first"),
            cnn.ConvSpec(4, 8, 3, groups=2), cnn.ConvSpec(8, 10, 1,
                                                           role="last")]
    with pytest.raises(P.PlanError, match=r"layer 1 \(ConvSpec\(cin=4"):
        P.compile_model(None, spec, W1A4, img_hw=16)
    fp = QuantConfig(w_bits=32, a_bits=32, g_bits=32, engine="fp")
    with pytest.raises(P.PlanError, match=r"layer 1 \(conv1\): a depthwise"):
        P.compile_model(None, cnn.mobilenet_v1_spec(0.25), fp, img_hw=32)


def test_plan_serves_13_depthwise_layers_at_the_published_sides():
    plan = P.compile_model(None, cnn.mobilenet_v1_spec(), W1A4,
                           batch_hints=(8, 256), img_hw=224)
    layers = plan.layers
    assert [lp.out_h for lp in layers] == SIDES
    dw = [lp for lp in layers if lp.engine == "depthwise"]
    assert [(lp.in_h, lp.cout, lp.stride) for lp in dw] == DEPTHWISE
    assert all(lp.groups == lp.cout and lp.cin == 1 and lp.k == 9
               and lp.engines == ((8, "depthwise"), (256, "depthwise"))
               for lp in dw)
    # the pointwise layers: 1x1 GEMMs on fused_qgemm
    assert {lp.engine for lp in layers[2:-1:2]} == {"fused"}
    assert (layers[0].engine, layers[-1].engine) == ("fp", "fp")
    assert "groups" not in P._layer_to_json(layers[2])
    assert P._layer_to_json(layers[1])["groups"] == 32


def test_svhn_plans_keep_their_metadata():
    """A plan without a depthwise layer writes the keys it always wrote."""
    plan = P.compile_model(None, cnn.svhn_cnn_spec(8), W1A4, img_hw=16)
    assert all("groups" not in d for d in plan.meta()["layers"])


@pytest.mark.parametrize("engine", ["faithful", "fused", "implicit"])
def test_explicit_dense_engine_raises_naming_the_first_depthwise_layer(
        engine):
    import dataclasses

    q = dataclasses.replace(W1A4, engine=engine)
    with pytest.raises(P.PlanError, match=r"^layer 1 \(conv1, depthwise"):
        P.compile_model(None, cnn.mobilenet_v1_spec(), q, img_hw=224)
    with pytest.raises(P.PlanError, match=r"^layer 1 \(conv1, depthwise"):
        P.cnn_serve_layers(cnn.mobilenet_v1_spec(0.25), q, batch=2,
                           img_hw=(32, 32))


def test_the_prover_holds_the_kernels_limits():
    from repro_torch.analysis.prover import verify_plan
    from repro_torch.kernels import ops

    plan = P.compile_model(None, cnn.mobilenet_v1_spec(), W1A4,
                           batch_hints=(8,), img_hw=224)
    assert verify_plan(plan) == []
    import dataclasses

    bad = dataclasses.replace(plan.layers[1], stride=3)
    got = verify_plan(dataclasses.replace(
        plan, layers=(plan.layers[0], bad) + plan.layers[2:]))
    assert [v.rule for v in got] == ["PV103"] and "not 3" in got[0].message
    conv = ops.ConvShape(14, 14, 3, 3, 1, "SAME", batch=8, groups=30)
    assert not ops.engine_feasible("depthwise", 0, 9, 30, 4, 1, "cuda",
                                   conv)[0]
    assert not ops.engine_feasible("depthwise", 0, 9, 32, 4, 1, "cuda",
                                   ops.ConvShape(14, 14, 5, 5, 1, "SAME",
                                                 groups=32))[0]
    assert not ops.engine_feasible("depthwise", 64, 9, 32, 4, 1, "cuda")[0]


def test_norm_act_takes_two_passes_on_exactly_the_six_large_slabs():
    """(112, 112, 32) twice, (112, 112, 64) once, (56, 56, 128) three
    times: 6 of the 27 hidden norms, 2.81 M of 5.04 M elements an image."""
    plan = P.compile_model(None, cnn.mobilenet_v1_spec(), W1A4,
                           batch_hints=(256,), img_hw=224)
    hidden = [(lp.out_h, lp.out_w, lp.cout) for lp in plan.layers[:-1]]
    two = [s for s in hidden if plan_for(*s).path == "two_pass"]
    assert two == [(112, 112, 32)] * 2 + [(112, 112, 64)] + [(56, 56, 128)] * 3
    assert sum(math.prod(s) for s in two) == 2_809_856
    assert sum(math.prod(s) for s in hidden) == 5_042_688


def test_the_training_forward_refuses_a_depthwise_layer_naming_it():
    spec = cnn.mobilenet_v1_spec(0.25)
    params = cnn.init_cnn(torch.Generator().manual_seed(0), spec)
    h = torch.rand((1, 16, 16, 8))
    with pytest.raises(ValueError,
                       match=r"ConvSpec\(cin=1, cout=8, k=3, stride=1.*"
                             r"groups=8\): the training forward"):
        cnn.conv_bias(params[1], spec[1], h, W1A4)
    with pytest.raises(ValueError, match=r"groups=8\): the training"):
        cnn.cnn_forward(params, torch.rand((1, 32, 32, 3)), spec, W1A4,
                        "train")


def test_the_benchmarks_copy_is_the_reference():
    """``chipbench/`` carries its own copy of the reference; the two are
    one file."""
    root = Path(__file__).resolve().parents[1]
    assert ((root / "chipbench" / "reference" / "mobilenet_v1.py")
            .read_bytes() == (root / "reference" / "mobilenet_v1.py")
            .read_bytes())


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("side", [7, 8, 13])
@pytest.mark.parametrize("bits", [(4, 1), (8, 8)])
def test_dwconv_plain_is_the_references_grouped_conv_on_levels(stride, side,
                                                               bits):
    """With the scale pinned to 1 (s_w = 2^a - 1), the output is the
    level sum itself: the reference's float64 grouped conv on the padded
    levels, exactly."""
    a_bits, w_bits = bits
    rs = np.random.RandomState(side + 10 * stride + a_bits)
    c = 12
    x = torch.from_numpy(rs.randint(0, 1 << a_bits, (3, side, side + 1, c))
                         .astype(np.uint8))
    w = torch.from_numpy(rs.randint(0, 1 << w_bits, (9, c)).astype(np.uint8))
    z = ((1 << w_bits) - 1) / 2.0
    got = dwconv_plain(x, w, float((1 << a_bits) - 1), z, stride=stride,
                       a_bits=a_bits, w_bits=w_bits)
    xn = R.same_pad(x.permute(0, 3, 1, 2).double(), 3, stride)
    wk = (w.double() - z).T.reshape(c, 1, 3, 3)
    want = F.conv2d(xn, wk, stride=stride, groups=c).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    assert torch.equal(got.double(), want)
    assert got.shape[1:3] == (-(-side // stride), -(-(side + 1) // stride))


def test_dwconv_wrapper_runs_the_plain_version_on_the_cpu():
    x = torch.randint(0, 16, (2, 9, 9, 8), dtype=torch.uint8)
    w = torch.randint(0, 2, (9, 8), dtype=torch.uint8)
    before, counters = dict(_lib.LAUNCHES), dict(TRACER.counters)
    got = dwconv(x, w, 0.3, 0.5, stride=2, a_bits=4, w_bits=1)
    assert torch.equal(got, dwconv_plain(x, w, 0.3, 0.5, stride=2, a_bits=4,
                                         w_bits=1))
    assert _lib.LAUNCHES == before and TRACER.counters == counters
    with pytest.raises(ValueError, match="stride 1 or 2"):
        dwconv(x, w, 0.3, 0.5, stride=3, a_bits=4, w_bits=1)
    with pytest.raises(ValueError, match="4-byte vectors"):
        dwconv(x[..., :6].contiguous(), w[:, :6].contiguous(), 0.3, 0.5,
               a_bits=4, w_bits=1)
    with pytest.raises(ValueError, match="not an integer"):
        dwconv(x, w, 0.3, 0.3, a_bits=4, w_bits=1)


# ---------------------------------------------------------------------------
# the executor against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_executor_equals_the_reference_at_width_one_quarter(seed):
    """Every hidden layer's levels bit for bit; the logits within 1e-5 of
    their largest: the float classifier's 1x1 conv reads its input in NHWC
    in the program and NCHW in the reference, so the two may sum in
    different orders (they agree exactly here)."""
    layers = R.network(SMALL)
    params = _params(layers, seed)
    spec = cnn.mobilenet_v1_spec(0.25)
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(
        seed + 1))
    with R.no_tf32():
        hidden, want = R.states(params, x, SMALL)
    outs = []
    norm = cnn._norm_act

    def observed(*args, **kwargs):
        outs.append(norm(*args, **kwargs))
        return outs[-1]

    cnn._norm_act = observed
    try:
        got = P.execute_cnn_layers(P.cnn_serve_layers(
            spec, W1A4, batch=2, img_hw=(32, 32)), params, x, W1A4,
            reference=True)
    finally:
        cnn._norm_act = norm
    assert len(outs) == len(hidden) == 27
    for i, (a, b) in enumerate(zip(outs, hidden)):
        assert torch.equal(torch.round(a * 15), torch.round(b * 15)), i
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_served_forward_spans_each_depthwise_conv():
    spec = cnn.mobilenet_v1_spec(0.25)
    compiled = api.build(spec, W1A4, params=cnn.init_cnn(
        torch.Generator().manual_seed(0), spec), img_hw=32).compile(
        target="cuda", batch_hints=(2,))
    t0 = TRACER.clock()
    compiled.forward(torch.rand((2, 32, 32, 3)))
    recs = TRACER.records(t0)
    plan = recs.where("executor.plan")
    dw, conv = recs.where("executor.dwconv"), recs.where("executor.conv")
    assert len(plan) == 1 and (len(dw), len(conv)) == (13, 15)
    assert set(dw.parent.tolist()) == set(plan.index.tolist())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("batch", [8, 256])
@pytest.mark.parametrize("layer", range(13))
def test_dwconv_kernel_equals_plain_at_the_layer_shapes(cuda_device, batch,
                                                        layer):
    side, c, stride = DEPTHWISE[layer]
    gen = torch.Generator(device=cuda_device).manual_seed(layer + batch)
    x = torch.randint(0, 16, (batch, side, side, c), generator=gen,
                      dtype=torch.uint8, device=cuda_device)
    w = torch.randint(0, 2, (9, c), generator=gen, dtype=torch.uint8,
                      device=cuda_device)
    _lib.reset_launches()
    n = TRACER.counters.get(f"kernels.dwconv.s{stride}", 0)
    got = dwconv(x, w, 0.0731, 0.5, stride=stride, a_bits=4, w_bits=1)
    want = dwconv_plain(x, w, 0.0731, 0.5, stride=stride, a_bits=4,
                        w_bits=1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _lib.LAUNCHES["dwconv"] == 1
    assert TRACER.counters[f"kernels.dwconv.s{stride}"] == n + 1


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(1, 1), (5, 9), (16, 15)])
def test_dwconv_kernel_at_8_bits_and_ragged_rows(cuda_device, stride, hw):
    """The largest sums (8-bit levels at both ends) and rows whose last
    thread holds fewer than its 4 pixels."""
    gen = torch.Generator(device=cuda_device).manual_seed(stride)
    x = torch.randint(0, 256, (3, *hw, 20), generator=gen,
                      dtype=torch.uint8, device=cuda_device)
    w = torch.randint(0, 256, (9, 20), generator=gen, dtype=torch.uint8,
                      device=cuda_device)
    x[0] = 255
    w[:, :4] = 255
    got = dwconv(x, w, 0.01, 127.5, stride=stride, a_bits=8, w_bits=8)
    want = dwconv_plain(x, w, 0.01, 127.5, stride=stride, a_bits=8,
                        w_bits=8)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_served_forward_on_the_card_is_held_to_the_oracle(cuda_device):
    """Width 0.25 at 64 x 64: 13 dwconv, 13 fused_qgemm and 27 norm_act
    launches and nothing else; under the plain norm (the statistics sum in
    the oracle's order) the logits are the oracle's bit for bit."""
    from repro_torch.kernels import norm_act as N

    spec = cnn.mobilenet_v1_spec(0.25)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    compiled = api.build(spec, W1A4, params=cnn.init_cnn(gen, spec),
                         img_hw=64).compile(target="cuda", batch_hints=(4,))
    x = torch.rand((4, 64, 64, 3), generator=gen, device=cuda_device)
    _lib.reset_launches()
    compiled.forward(x)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES == {k: dict(dwconv=13, fused_qgemm=13,
                                     norm_act=27).get(k, 0)
                             for k in _lib.LAUNCHES}
    kernel = N.norm_act
    N.norm_act = N.norm_act_plain
    try:
        got = compiled.forward(x)
    finally:
        N.norm_act = kernel
    assert torch.equal(got, compiled.forward(x, reference=True))
