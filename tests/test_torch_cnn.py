"""Port parity: conv lowering, the CNN serve pieces, and each quantized
layer teacher-forced (whole forwards: ``test_torch_forward.py``).

The port's ``cuda`` plans run here on the CPU through the kernels' plain
versions; the reference runs its own ``cpu`` plans.  The two compute the
same integer accumulators, so what differs is float32 rounding in the
fp layers, the per-sample norm and the pools — and, downstream of it,
activation levels that flip where a value sits on an exact .5 boundary.

Tolerances, and why:

* single float ops (fp conv, pool, resize, norm before quantization):
  rtol = atol = 1e-5, float32 summation order;
* a quantized layer fed the reference's own input: its output within
  1e-5 of the jitted reference (FMA contraction in XLA's epilogue), and
  its requantized levels identical except where the reference's value
  sits within 1e-3 of a .5 boundary (counted, at most 0.5% of levels);
* whole forwards: see ``test_torch_forward.py``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import conv_lowering as jlow  # noqa: E402
from repro.core import plan as jplan_mod  # noqa: E402
from repro.core.prequant import prequantize_cnn_params  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import conv_lowering as low  # noqa: E402
from repro_torch.core import plan as plan_mod  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
HALF_WINDOW = 1e-3       # |frac(x * n) - 0.5| below this counts as a tie
MAX_FLIP_FRAC = 5e-3


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np_params(spec, seed):
    """init_cnn's layout and scale, drawn with numpy (the reference's JAX
    PRNG init is slow to trace op by op and is not what is under test)."""
    rs = np.random.RandomState(seed)
    return [dict(w=(rs.normal(size=(s.k, s.k, s.cin, s.cout))
                    / np.sqrt(s.k * s.k * s.cin)).astype(np.float32),
                 b=np.zeros(s.cout, np.float32), g=np.ones(s.cout, np.float32),
                 beta=np.zeros(s.cout, np.float32)) for s in spec]


def _both_plans(jspec, tspec, qname, img_hw, batch, seed=0):
    """Reference cpu plan and port cuda plan over the SAME prequantized
    levels and scales (the reference's own, carried by convert)."""
    jq, tq = jquant.PAPER_CONFIGS[qname], quant.PAPER_CONFIGS[qname]
    levels = jax.jit(lambda p: prequantize_cnn_params(p, jspec, jq))(
        _np_params(jspec, seed))
    jp = jplan_mod.compile_model(levels, jspec, jq, backend="cpu",
                                 batch_hints=(batch,), img_hw=img_hw)
    tparams = convert.cnn_params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jp.params], "cpu")
    tp = plan_mod.compile_model(tparams, tspec, tq, target="cuda",
                                batch_hints=(batch,), img_hw=img_hw)
    return jp, tp


# ---------------------------------------------------------------------------
# conv lowering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,k,stride", [(9, 7, 3, 1), (9, 7, 3, 2),
                                          (224, 224, 11, 4), (10, 11, 5, 2),
                                          (6, 6, 6, 1), (7, 5, 2, 3)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_out_hw_and_pad_split_match(h, w, k, stride, padding):
    assert low._out_hw(h, w, k, k, stride, padding) == jlow._out_hw(
        h, w, k, k, stride, padding)
    assert low.pad_split(h, w, k, k, stride, padding) == jlow.pad_split(
        h, w, k, k, stride, padding)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_im2col_sliced_identical_on_levels(stride, padding):
    x = np.random.RandomState(stride).randint(0, 256, (2, 9, 7, 5)).astype(
        np.uint8)
    got = low.im2col_sliced(torch.from_numpy(x), 3, 2, stride, padding)
    ref = jlow.im2col_sliced(jnp.asarray(x).astype(jnp.int32), 3, 2, stride,
                             padding)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy().astype(np.int32),
                                  np.asarray(ref))


@pytest.mark.parametrize("shape,k,stride", [((2, 45, 43, 3), 11, 4),
                                            ((2, 40, 40, 3), 5, 1),
                                            ((1, 9, 7, 4), 3, 2)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv2d_float_matches_lax_including_stride4_same(shape, k, stride,
                                                         padding):
    """AlexNet's fp stem is 11x11 stride 4 SAME: lax splits that padding
    asymmetrically, which F.conv2d(padding="same") cannot do."""
    rs = np.random.RandomState(k)
    x = rs.uniform(0, 1, shape).astype(np.float32)
    w = (rs.normal(size=(k, k, shape[-1], 8)) / k).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a, b: jlow.conv2d_float(
        a, b, stride=stride, padding=padding))(x, w))
    got = low.conv2d_float(_t(x), _t(w), stride=stride, padding=padding)
    assert got.is_contiguous() and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_quant_conv2d_pre_routes_through_the_engine():
    rs = np.random.RandomState(0)
    x = rs.uniform(-0.2, 1.2, (2, 8, 8, 4)).astype(np.float32)
    w = rs.normal(size=(3, 3, 4, 6)).astype(np.float32)
    from repro.core.prequant import prequantize_conv_weight as jpre

    w_lv, s_w, z_w = jpre(jnp.asarray(w), 1)
    ref = np.asarray(jlow.quant_conv2d_pre(x, w_lv, s_w, z_w, kh=3, kw=3,
                                           a_bits=4, w_bits=1, engine="int8"))
    for eng in ("implicit", "fused"):
        got = low.quant_conv2d_pre(
            _t(x), torch.from_numpy(np.asarray(w_lv).astype(np.uint8)),
            float(s_w), float(z_w), kh=3, kw=3, a_bits=4, w_bits=1,
            engine=eng)
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


# ---------------------------------------------------------------------------
# serve pieces between the convolutions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("role", ["mid", "last"])
def test_norm_act_serve_per_sample_population_variance(role):
    rs = np.random.RandomState(1)
    x = rs.normal(size=(3, 6, 5, 8)).astype(np.float32)
    g = rs.uniform(0.5, 1.5, 8).astype(np.float32)
    beta = rs.uniform(-0.2, 0.6, 8).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: jcnn._norm_act(
        v, g, beta, jquant.W1A4, role, "serve"))(x))
    got = cnn._norm_act(_t(x), _t(g), _t(beta), quant.W1A4, role).numpy()
    if role == "last":     # clipped, not quantized: plain float
        np.testing.assert_allclose(got, ref, **TOL)
    else:  # quantized: XLA turns "/ n" into "* (1/n)", so compare levels
        lv_got, lv_ref = np.rint(got * 15), np.rint(ref * 15)
        assert (lv_got != lv_ref).mean() <= MAX_FLIP_FRAC
    # train mode takes batch statistics over (B, H, W), as the reference's
    ref = np.asarray(jax.jit(lambda v: jcnn._norm_act(
        v, g, beta, jquant.W1A4, role, "train"))(x))
    got = cnn._norm_act(_t(x), _t(g), _t(beta), quant.W1A4, role,
                        "train").numpy()
    if role == "last":
        np.testing.assert_allclose(got, ref, **TOL)
    else:
        lv_got, lv_ref = np.rint(got * 15), np.rint(ref * 15)
        assert (lv_got != lv_ref).mean() <= MAX_FLIP_FRAC


def test_avg_pool2_matches_reduce_window():
    x = np.random.RandomState(2).normal(size=(2, 7, 6, 3)).astype(np.float32)
    ref = np.asarray(jax.lax.reduce_window(
        x, 0.0, jax.lax.add, (1, 2, 2, 1), (1, 2, 2, 1), "VALID") / 4.0)
    got = cnn.avg_pool2(_t(x)).numpy()
    assert got.shape == ref.shape == (2, 3, 3, 3)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("src,dst", [(7, 6), (2, 6), (3, 6), (13, 6)])
def test_resize_linear_matches_jax_image_resize(src, dst):
    """7 -> 6 is AlexNet at 224 (a downsample, so JAX antialiases: the
    triangle kernel widens by 7/6); 2 -> 6 and 3 -> 6 upsample."""
    x = np.random.RandomState(src).normal(size=(2, src, src, 5)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda v: jax.image.resize(
        v, (2, dst, dst, 5), "linear"))(x))
    got = cnn.resize_linear(_t(x), dst).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


# ---------------------------------------------------------------------------
# each quantized layer fed the reference's own input
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qname", ["w1a4", "w1a8"])
def test_each_quantized_layer_teacher_forced(qname):
    jspec, tspec = jcnn.svhn_cnn_spec(16), cnn.svhn_cnn_spec(16)
    jp, tp = _both_plans(jspec, tspec, qname, 40, 2)
    jq, tq = jp.quant, tp.quant
    n = (1 << jq.a_bits) - 1
    x = np.random.RandomState(7).uniform(0, 1, (2, 40, 40, 3)).astype(
        np.float32)
    h = jnp.asarray(x)
    last = len(jp.layers) - 1
    flips = total = 0
    for jl, tl, jpar, tpar in zip(jp.layers, tp.layers, jp.params, tp.params):
        if jl.fp:
            out = jax.jit(lambda v, w, jl=jl: jlow.conv2d_float(
                v, w, stride=jl.stride, padding=jl.padding))(h, jpar["w"])
        else:
            out = jax.jit(lambda v, jl=jl, jpar=jpar: jlow.quant_conv2d_pre(
                v, jpar["w_lv"], jpar["s_w"], jpar["z_w"], kh=jl.kh,
                kw=jl.kw, stride=jl.stride, padding=jl.padding,
                a_bits=jl.a_bits, w_bits=jl.w_bits, engine=jl.engine))(h)
            got = low.quant_conv2d_pre(
                _t(h), tpar["w_lv"], tpar["s_w"], tpar["z_w"], kh=tl.kh,
                kw=tl.kw, stride=tl.stride, padding=tl.padding,
                a_bits=tl.a_bits, w_bits=tl.w_bits, engine=tl.engine)
            np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
        out = out + jpar["b"]
        if jl.index < last:
            pre = np.asarray(jax.jit(lambda v, jpar=jpar: jcnn._norm_act(
                v, jpar["g"], jpar["beta"], jquant.FP32, "mid",
                "serve"))(out))              # clipped, before quantizing
            ref = jax.jit(lambda v, jpar=jpar, jl=jl: jcnn._norm_act(
                v, jpar["g"], jpar["beta"], jq, jl.role, "serve"))(out)
            got = cnn._norm_act(_t(out), tpar["g"], tpar["beta"], tq,
                                tl.role).numpy()
            lv_ref = np.rint(np.asarray(ref) * n)
            lv_got = np.rint(got * n)
            diff = lv_ref != lv_got
            ties = np.abs((pre * n) % 1.0 - 0.5) < HALF_WINDOW
            assert not (diff & ~ties).any(), "a level flipped off a .5 tie"
            assert (np.abs(lv_ref - lv_got) <= 1).all()
            flips += int(diff.sum())
            total += diff.size
            h = ref
        else:
            h = out
        if jl.pool:
            h = jax.lax.reduce_window(h, 0.0, jax.lax.add, (1, 2, 2, 1),
                                      (1, 2, 2, 1), "VALID") / 4.0
    assert flips <= MAX_FLIP_FRAC * total, (flips, total)
