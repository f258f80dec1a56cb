"""Port parity: the implicit-GEMM conv kernel's plain version and wrapper.

``conv_implicit`` of ``repro_torch`` against the JAX package's
``conv_implicit_pallas`` (interpret mode) and its jitted
``conv_implicit_xla``, on the same numpy levels: accumulators and rowsums
exactly (pinned scales), the full epilogue within rtol = atol = 1e-5 (see
``test_torch_kernels.py`` for the reasons).  The CUDA kernel runs only on
a card: ``test_torch_gpu.py``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.conv_implicit import (conv_implicit_pallas,  # noqa: E402
                                         conv_implicit_xla)
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.conv_implicit import (SMEM_LIMIT,  # noqa: E402
                                               conv_implicit,
                                               conv_implicit_plain,
                                               smem_layout)
from test_torch_kernels import (BITS, TOL, _pinned,  # noqa: E402
                                _ref_level_dtype, _rowsum_scales)


def _conv_problem(wb, ab, *, b=2, h=9, w=7, cin=5, cout=7, kh=3, kw=3,
                  seed=0):
    rs = np.random.RandomState(seed)
    x_lv = rs.randint(0, 1 << ab, (b, h, w, cin)).astype(np.uint8)
    w_lv = rs.randint(0, 1 << wb, (kh * kw * cin, cout)).astype(np.uint8)
    s_w = np.float32(rs.uniform(0.01, 0.1))
    z_w = np.float32(0.5 if wb == 1 else ((1 << wb) - 1) / 2.0)
    return x_lv, w_lv, s_w, z_w


@pytest.mark.parametrize("wb,ab", BITS)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_plain_accumulator_exact_vs_pallas(wb, ab, stride, padding):
    x_lv, w_lv, _, _ = _conv_problem(wb, ab, seed=ab * 10 + stride)
    s1, z0 = _pinned(ab)
    kw_args = dict(kh=3, kw=3, stride=stride, padding=padding, a_bits=ab,
                   w_bits=wb)
    ref = np.asarray(conv_implicit_pallas(
        jnp.asarray(x_lv).astype(_ref_level_dtype(ab)),
        jnp.asarray(w_lv).astype(jnp.int8), jnp.asarray(s1), jnp.asarray(z0),
        interpret=True, **kw_args))
    got = conv_implicit_plain(torch.from_numpy(x_lv), torch.from_numpy(w_lv),
                              s1, z0, **kw_args).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("wb,ab", BITS)
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_plain_rowsum_exact_vs_pallas(wb, ab, stride):
    """The per-pixel rowsum over the SAME-padded window (padding counts as
    level 0) — the kernel's separate pass — against the Pallas kernel."""
    x_lv, w_lv, _, _ = _conv_problem(wb, ab, seed=3 * ab + stride)
    s1, zm1 = _rowsum_scales(ab)
    w0 = np.zeros_like(w_lv)
    kw_args = dict(kh=3, kw=3, stride=stride, padding="SAME", a_bits=ab,
                   w_bits=wb)
    got = conv_implicit_plain(torch.from_numpy(x_lv), torch.from_numpy(w0),
                              s1, zm1, **kw_args).numpy()
    ref = np.asarray(conv_implicit_pallas(
        jnp.asarray(x_lv).astype(_ref_level_dtype(ab)), jnp.asarray(w0),
        jnp.asarray(s1), jnp.asarray(zm1), interpret=True, **kw_args))
    np.testing.assert_array_equal(got, ref)
    assert (got[..., 0] == got[..., -1]).all() and got.max() > 0


@pytest.mark.parametrize("wb,ab", BITS)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_plain_full_epilogue_vs_jitted_xla(wb, ab, stride, padding):
    x_lv, w_lv, s_w, z_w = _conv_problem(wb, ab, h=10, w=11, cin=6, cout=9,
                                         seed=ab + stride)
    kw_args = dict(kh=3, kw=3, stride=stride, padding=padding, a_bits=ab,
                   w_bits=wb)
    ref = np.asarray(conv_implicit_xla(
        jnp.asarray(x_lv).astype(jnp.int32), jnp.asarray(w_lv),
        jnp.asarray(s_w), jnp.asarray(z_w), **kw_args))
    got = conv_implicit_plain(torch.from_numpy(x_lv), torch.from_numpy(w_lv),
                              s_w, z_w, **kw_args).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_conv_plain_rectangular_kernel_and_wide_cout():
    """kh != kw and Cout past one 64-channel tile (the kernel's ragged
    channel edge), exact against the Pallas kernel."""
    x_lv, w_lv, _, _ = _conv_problem(1, 4, h=8, w=9, cin=3, cout=70, kh=2,
                                     kw=3, seed=5)
    s1, z0 = _pinned(4)
    kw_args = dict(kh=2, kw=3, stride=1, padding="SAME", a_bits=4, w_bits=1)
    ref = np.asarray(conv_implicit_pallas(
        jnp.asarray(x_lv).astype(jnp.int8), jnp.asarray(w_lv).astype(jnp.int8),
        jnp.asarray(s1), jnp.asarray(z0), interpret=True, **kw_args))
    got = conv_implicit_plain(torch.from_numpy(x_lv), torch.from_numpy(w_lv),
                              s1, z0, **kw_args).numpy()
    np.testing.assert_array_equal(got, ref)


def test_conv_wrapper_on_cpu_is_the_plain_version_and_validates():
    x_lv, w_lv, s_w, z_w = _conv_problem(1, 8)
    x, w = torch.from_numpy(x_lv), torch.from_numpy(w_lv)
    kw_args = dict(kh=3, kw=3, stride=2, padding="SAME", a_bits=8, w_bits=1)
    before = dict(_lib.LAUNCHES)
    assert torch.equal(conv_implicit(x, w, s_w, z_w, **kw_args),
                       conv_implicit_plain(x, w, s_w, z_w, **kw_args))
    assert _lib.LAUNCHES == before
    with pytest.raises(TypeError):
        conv_implicit(x.to(torch.int32), w, s_w, z_w, **kw_args)
    with pytest.raises(ValueError):
        conv_implicit(x, w[:-1], s_w, z_w, **kw_args)
    with pytest.raises(ValueError):
        conv_implicit(x, w, s_w, z_w, **{**kw_args, "padding": "FULL"})
    with pytest.raises(ValueError):
        conv_implicit(x.permute(0, 2, 1, 3), w, s_w, z_w,
                      **{**kw_args, "stride": 1})


def test_smem_layout_of_main_path_layers():
    # svhn conv5 at batch 8: a 10x10x256 map, 16-pixel tiles (224 blocks)
    # staging 5 x 12 pixels at a 272-byte (17-chunk) pitch; AlexNet conv3:
    # 14x14x384, 64-pixel tiles staging 8 x 16 pixels at 400 bytes (25
    # chunks), over 48 KB; Cin = 5 is zero-padded to one 16-byte chunk.
    # Each block adds the 4-stage weight ring (4 x 128 K rows x 64
    # channels), 12 bytes of tables per 16-channel chunk of K (144 chunks,
    # whole stages of 8), a zero chunk and one int32 rowsum per pixel.
    lay = smem_layout(10, 10, 256, 3, 3, 1, "SAME", 8, 256)
    assert lay == (16, 272, 5 * 12 * 272, 5 * 12 * 272 + 32768 + 144 * 12
                   + 16 + 16 * 4)
    lay = smem_layout(14, 14, 384, 3, 3, 1, "SAME", 8, 384)
    assert lay[:3] == (64, 400, 8 * 16 * 400)
    assert 48 * 1024 < lay.smem_bytes <= SMEM_LIMIT
    lay = smem_layout(9, 7, 5, 3, 3, 2, "VALID", 2, 7)
    assert lay.tm == 16 and lay.cpitch == 16


# batch-8 main-path convs (svhn conv1-5, AlexNet conv1-4): (h, w, cin,
# cout, k) -> the pixel tile the kernel runs
MAIN_CONVS = [((40, 40, 64, 64, 3), 64), ((40, 40, 64, 128, 3), 128),
              ((20, 20, 128, 128, 3), 32), ((20, 20, 128, 256, 3), 64),
              ((10, 10, 256, 256, 3), 16), ((28, 28, 96, 256, 5), 128),
              ((14, 14, 256, 384, 3), 64), ((14, 14, 384, 384, 3), 64),
              ((14, 14, 384, 256, 3), 32)]


@pytest.mark.parametrize("geom,tm", MAIN_CONVS, ids=lambda v: str(v))
def test_conv_tile_plan_fills_the_card_at_main_path_shapes(geom, tm):
    """The largest pixel tile whose grid has a block on every SM, inside
    shared memory; smaller tiles only where the grid would not fill."""
    from repro_torch.kernels.conv_implicit import SMS, TMS, TN

    h, w, cin, cout, k = geom
    lay = smem_layout(h, w, cin, k, k, 1, "SAME", 8, cout)
    assert lay.tm == tm and lay.smem_bytes <= SMEM_LIMIT
    blocks = lambda t: 8 * -(-h * w // t) * -(-cout // TN)  # noqa: E731
    assert blocks(tm) >= SMS
    assert all(blocks(t) < SMS for t in TMS if t > tm)
    assert lay.cpitch % 32 == 16 and lay.cpitch >= cin
