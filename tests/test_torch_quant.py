"""Port parity: quantizers, weight pre-quantization and weight conversion.

``repro_torch`` against ``repro`` on the same numpy inputs.  Integer levels
must be identical.  The 1-bit scale ``2*mean|w|`` is where the two may
differ: the port rounds a float64 mean once (the correctly rounded value),
while XLA sums in float32, and on this CPU its result lands up to 13 ulps
from the correctly rounded mean (measured on every layer shape of svhn at
widths 16 and 64 and of AlexNet).  No port can match that to 1 ulp without
copying XLA's summation order, so the port's scale is pinned to the
float64 value exactly and to the reference's within SCALE_ULPS.  The
kernels are held against the reference's own levels and scales
(:mod:`repro_torch.convert`), so this bound never enters their tests.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import prequant as jprequant  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.models.cnn import svhn_cnn_spec as jsvhn_spec  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import prequant, quant  # noqa: E402
from repro_torch.models.cnn import svhn_cnn_spec  # noqa: E402

BITS = [1, 2, 4, 8]


def _np_params(spec, seed):
    """init_cnn's layout and scale (N(0, 1/fan_in) HWIO weights, zero bias,
    unit g, zero beta), drawn with numpy."""
    rs = np.random.RandomState(seed)
    return [dict(w=(rs.normal(size=(s.k, s.k, s.cin, s.cout))
                    / np.sqrt(s.k * s.k * s.cin)).astype(np.float32),
                 b=np.zeros(s.cout, np.float32), g=np.ones(s.cout, np.float32),
                 beta=np.zeros(s.cout, np.float32)) for s in spec]


SCALE_ULPS = 16   # XLA's float32 mean vs the correctly rounded one


def _ulps(a, b) -> int:
    a, b = np.float32(a), np.float32(b)
    return int(abs(int(a.view(np.int32)) - int(b.view(np.int32))))


def test_paper_configs_mirror_reference():
    assert set(quant.PAPER_CONFIGS) == set(jquant.PAPER_CONFIGS)
    for k, q in quant.PAPER_CONFIGS.items():
        r = jquant.PAPER_CONFIGS[k]
        assert (q.w_bits, q.a_bits, q.g_bits, q.engine, q.first_last_fp) == \
            (r.w_bits, r.a_bits, r.g_bits, r.engine, r.first_last_fp)
        assert q.tag() == r.tag()


def test_round_half_to_even_on_exact_half_grid():
    x = np.arange(-8, 8, dtype=np.float32) + np.float32(0.5)
    got = torch.round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.round(x)))
    np.testing.assert_array_equal(got, np.round(x))   # numpy: half to even
    assert got[8] == 0.0 and got[9] == 2.0            # 0.5 -> 0, 1.5 -> 2


@pytest.mark.parametrize("bits", BITS)
def test_activation_levels_identical_including_half_boundaries(bits):
    n = (1 << bits) - 1
    rs = np.random.RandomState(bits)
    # exact k/n and (k+0.5)/n points plus out-of-range and random values
    grid = np.concatenate([np.arange(n + 1) / n, (np.arange(n) + 0.5) / n])
    a = np.concatenate([grid, rs.uniform(-0.3, 1.3, 500)]).astype(np.float32)
    lv, s = quant.activation_levels(torch.from_numpy(a), bits)
    jlv, js = jquant.activation_levels(jnp.asarray(a), bits)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
    assert np.float32(s) == np.asarray(js)
    q = quant.quantize_activation(torch.from_numpy(a), bits).numpy()
    np.testing.assert_array_equal(q, np.asarray(jquant.quantize_activation(
        jnp.asarray(a), bits)))


@pytest.mark.parametrize("bits", BITS)
def test_weight_levels_identical_scales_within_ulps(bits):
    w = np.random.RandomState(10 + bits).normal(size=(3, 3, 16, 24)).astype(
        np.float32)
    lv, s, z = quant.weight_levels(torch.from_numpy(w), bits)
    jlv, js, jz = jquant.weight_levels(jnp.asarray(w), bits)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
    assert _ulps(float(s), np.asarray(js)) <= SCALE_ULPS
    assert float(z) == float(np.asarray(jz))
    if bits == 1:
        exact = np.float32(2.0 * np.abs(w.astype(np.float64)).mean())
        assert np.float32(float(s)) == exact


@pytest.mark.parametrize("bits", [1, 2, 8])
def test_prequantize_conv_weight_layout_and_dtype(bits):
    w = np.random.RandomState(bits).normal(size=(5, 3, 7, 6)).astype(np.float32)
    lv, s, z = prequant.prequantize_conv_weight(torch.from_numpy(w), bits)
    jlv, js, jz = jprequant.prequantize_conv_weight(jnp.asarray(w), bits)
    assert lv.dtype == torch.uint8 and lv.shape == (5 * 3 * 7, 6)
    assert lv.is_contiguous()
    np.testing.assert_array_equal(lv.numpy().astype(np.int32),
                                  np.asarray(jlv).astype(np.int32))
    assert _ulps(s, np.asarray(js)) <= SCALE_ULPS
    assert z == float(np.asarray(jz))
    assert prequant.level_dtype(bits) == torch.uint8
    assert prequant.level_dtype(16) == torch.int32


@pytest.mark.parametrize("qname", ["w1a4", "w1a8", "w2a2"])
def test_prequantize_cnn_params_matches_reference(qname):
    spec_j, spec_t = jsvhn_spec(8), svhn_cnn_spec(8)
    jparams = _np_params(spec_j, 3)
    jq, tq = jquant.PAPER_CONFIGS[qname], quant.PAPER_CONFIGS[qname]
    ref = jax.jit(lambda p: jprequant.prequantize_cnn_params(p, spec_j, jq))(
        jparams)
    tparams = convert.cnn_params_from_numpy(jparams, "cpu")
    got = prequant.prequantize_cnn_params(tparams, spec_t, tq)
    assert prequant.is_prequantized(got)
    for s, g, r in zip(spec_t, got, ref):
        assert prequant.is_fp_layer(s, tq) == ("w" in r)
        if "w" in r:
            np.testing.assert_array_equal(g["w"].numpy(), np.asarray(r["w"]))
            continue
        np.testing.assert_array_equal(g["w_lv"].numpy().astype(np.int32),
                                      np.asarray(r["w_lv"]).astype(np.int32))
        assert _ulps(g["s_w"], np.asarray(r["s_w"])) <= SCALE_ULPS
        assert g["z_w"] == float(np.asarray(r["z_w"]))


def test_convert_carries_reference_levels_and_scales_exactly():
    spec_j = jsvhn_spec(8)
    jparams = _np_params(spec_j, 5)
    ref = jax.jit(lambda p: jprequant.prequantize_cnn_params(
        p, spec_j, jquant.W1A8))(jparams)
    got = convert.cnn_params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in ref], "cpu")
    for g, r in zip(got, ref):
        for k, v in r.items():
            if k in ("s_w", "z_w"):
                assert isinstance(g[k], float)
                assert np.float32(g[k]) == np.asarray(v)
            elif k == "w_lv":
                assert g[k].dtype == torch.uint8
                np.testing.assert_array_equal(g[k].numpy(),
                                              np.asarray(v).astype(np.uint8))
            else:
                assert g[k].dtype == torch.float32
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(v))


def test_convert_rejects_levels_outside_uint8():
    with pytest.raises(ValueError, match="outside"):
        convert.cnn_params_from_numpy([{"w_lv": np.array([[-1, 2]])}], "cpu")
