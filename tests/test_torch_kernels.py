"""Port parity: the fused level-GEMM kernel's plain version and wrapper
(``conv_implicit``: ``test_torch_conv_implicit.py``).

``fused_qgemm`` of ``repro_torch`` against the JAX package's Pallas kernel
(run in interpret mode, as its own tests run it on the CPU) and its
jitted XLA realization, on the same numpy inputs.

* Integer accumulators and rowsums are compared exactly, through pinned
  scales (``s_w = 2^a_bits - 1``, ``z_w = 0``: the f32 output then IS the
  accumulator, exact below 2^24).
* Full-epilogue outputs agree within rtol = atol = 1e-5 with the *jitted*
  reference: both round ``s*acc - t*rowsum`` in float32, but XLA may fuse
  it into an FMA, which rounds once instead of twice.

The CUDA kernel itself runs only on a card: ``test_torch_gpu.py``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.and_accum import quant_dense_pre_levels  # noqa: E402
from repro.kernels.fused_qgemm import fused_qgemm_pallas  # noqa: E402
from repro_torch.core.and_accum import epilogue_scales  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.fused_qgemm import (fused_qgemm,  # noqa: E402
                                             fused_qgemm_plain, gemm_plan)

# (w_bits, a_bits): the paper's W1A1, W1A4, W1A8 and W2A2
BITS = [(1, 1), (1, 4), (1, 8), (2, 2)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _ref_level_dtype(bits):
    return jnp.int8 if bits <= 7 else jnp.int32


def _dense_problem(m, k, n, wb, ab, seed):
    rs = np.random.RandomState(seed)
    a = rs.uniform(-0.2, 1.2, (m, k)).astype(np.float32)
    a_lv = np.clip(np.round(np.clip(a, 0, 1) * ((1 << ab) - 1)), 0,
                   (1 << ab) - 1).astype(np.uint8)
    w_lv = rs.randint(0, 1 << wb, (k, n)).astype(np.uint8)
    s_w = np.float32(rs.uniform(0.01, 0.1)) if wb == 1 else np.float32(
        2.0 / ((1 << wb) - 1))
    z_w = np.float32(0.5 if wb == 1 else ((1 << wb) - 1) / 2.0)
    return a, a_lv, w_lv, s_w, z_w


def _pinned(ab):
    return np.float32((1 << ab) - 1), np.float32(0.0)


def test_pinned_scales_are_one_and_zero():
    for ab in (1, 2, 4, 8):
        assert epilogue_scales(ab, *_pinned(ab)) == (1.0, 0.0)


# ---------------------------------------------------------------------------
# fused_qgemm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wb,ab", BITS)
@pytest.mark.parametrize("m,k,n", [(5, 70, 9), (33, 130, 17)])
def test_fused_plain_accumulator_exact_vs_pallas(m, k, n, wb, ab):
    _, a_lv, w_lv, _, _ = _dense_problem(m, k, n, wb, ab, m + 7 * ab + wb)
    s1, z0 = _pinned(ab)
    ref = np.asarray(fused_qgemm_pallas(
        jnp.asarray(a_lv).astype(_ref_level_dtype(ab)),
        jnp.asarray(w_lv).astype(jnp.int8), jnp.asarray(s1), jnp.asarray(z0),
        a_bits=ab, w_bits=wb, a_is_levels=True, interpret=True))
    got = fused_qgemm_plain(torch.from_numpy(a_lv), torch.from_numpy(w_lv),
                            s1, z0, a_bits=ab, w_bits=wb, a_is_levels=True)
    exact = a_lv.astype(np.int64) @ w_lv.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))
    np.testing.assert_array_equal(got.numpy(), ref)


def _rowsum_scales(ab):
    """With W = 0 the output is ``-t * rowsum``; ``s_w = 2^a - 1`` and
    ``z_w = -1`` make ``s = 1`` and ``t = -1`` exactly, so it IS the
    rowsum."""
    return np.float32((1 << ab) - 1), np.float32(-1.0)


@pytest.mark.parametrize("wb,ab", BITS)
def test_fused_plain_rowsum_exact_vs_pallas(wb, ab):
    _, a_lv, w_lv, _, _ = _dense_problem(17, 90, 11, wb, ab, 3 + ab)
    s1, zm1 = _rowsum_scales(ab)
    w0 = np.zeros_like(w_lv)
    got = fused_qgemm_plain(torch.from_numpy(a_lv), torch.from_numpy(w0),
                            s1, zm1, a_bits=ab, w_bits=wb,
                            a_is_levels=True).numpy()
    ref = np.asarray(fused_qgemm_pallas(
        jnp.asarray(a_lv).astype(_ref_level_dtype(ab)), jnp.asarray(w0),
        jnp.asarray(s1), jnp.asarray(zm1), a_bits=ab, w_bits=wb,
        a_is_levels=True, interpret=True))
    rowsum = a_lv.astype(np.int64).sum(1).astype(np.float32)
    np.testing.assert_array_equal(got,
                                  np.broadcast_to(rowsum[:, None], got.shape))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("wb,ab", BITS)
def test_fused_plain_full_epilogue_vs_jitted_reference(wb, ab):
    a, a_lv, w_lv, s_w, z_w = _dense_problem(33, 130, 17, wb, ab, 11 * ab)
    ref = np.asarray(jax.jit(lambda x, w: quant_dense_pre_levels(
        x, w, s_w, z_w, ab, wb, engine="int8"))(a_lv.astype(np.int32), w_lv))
    pallas = np.asarray(fused_qgemm_pallas(
        jnp.asarray(a), jnp.asarray(w_lv).astype(jnp.int8), jnp.asarray(s_w),
        jnp.asarray(z_w), a_bits=ab, w_bits=wb, interpret=True))
    got_lv = fused_qgemm_plain(torch.from_numpy(a_lv), torch.from_numpy(w_lv),
                               s_w, z_w, a_bits=ab, w_bits=wb,
                               a_is_levels=True).numpy()
    got_f = fused_qgemm_plain(torch.from_numpy(a), torch.from_numpy(w_lv),
                              s_w, z_w, a_bits=ab, w_bits=wb).numpy()
    np.testing.assert_array_equal(got_lv, got_f)   # float-in == levels-in
    np.testing.assert_allclose(got_lv, ref, **TOL)
    np.testing.assert_allclose(got_lv, pallas, **TOL)


def test_fused_wrapper_on_cpu_is_the_plain_version_and_not_counted():
    _, a_lv, w_lv, s_w, z_w = _dense_problem(9, 40, 6, 1, 4, 0)
    before = dict(_lib.LAUNCHES)
    a, w = torch.from_numpy(a_lv), torch.from_numpy(w_lv)
    got = fused_qgemm(a, w, s_w, z_w, a_bits=4, w_bits=1, a_is_levels=True)
    ref = fused_qgemm_plain(a, w, s_w, z_w, a_bits=4, w_bits=1,
                            a_is_levels=True)
    assert torch.equal(got, ref)
    assert _lib.LAUNCHES == before


def test_fused_wrapper_validates_operands():
    a = torch.zeros((4, 8), dtype=torch.uint8)
    w = torch.zeros((8, 3), dtype=torch.uint8)
    with pytest.raises(TypeError):
        fused_qgemm(a.to(torch.int8), w, 1.0, 0.0, a_bits=4, w_bits=1,
                    a_is_levels=True)
    with pytest.raises(TypeError):   # float mode needs float32 activations
        fused_qgemm(a, w, 1.0, 0.0, a_bits=4, w_bits=1)
    with pytest.raises(ValueError):
        fused_qgemm(a, w[:7], 1.0, 0.0, a_bits=4, w_bits=1, a_is_levels=True)
    with pytest.raises(ValueError):
        fused_qgemm(a.t(), w[:4], 1.0, 0.0, a_bits=4, w_bits=1,
                    a_is_levels=True)
    with pytest.raises(ValueError):   # int32 accumulator bound
        fused_qgemm(torch.zeros((1, 40000), dtype=torch.uint8),
                    torch.zeros((40000, 1), dtype=torch.uint8), 1.0, 0.0,
                    a_bits=8, w_bits=8, a_is_levels=True)


# batch-8 and batch-1 main-path GEMMs of the fused kernel (svhn conv6,
# AlexNet fc5 and fc6): (M, K, N) -> (row tile, K step, K splits, K steps
# a split)
MAIN_GEMMS = [((800, 256, 512), (64, 64, 1, 4)),
              ((100, 256, 512), (64, 64, 1, 4)),
              ((8, 9216, 4096), (16, 128, 8, 9)),
              ((1, 9216, 4096), (16, 128, 8, 9)),
              ((8, 4096, 4096), (16, 128, 8, 4)),
              ((1, 4096, 4096), (16, 128, 8, 4))]


@pytest.mark.parametrize("mkn,want", MAIN_GEMMS, ids=lambda v: str(v))
def test_fused_split_plan_at_main_path_shapes(mkn, want):
    """The split-K plan of ``csrc/fused_qgemm.cu`` (its CPU-side copy;
    ``test_torch_gpu.py`` holds the kernel's export equal to it): splits
    cover K with none empty, stay within the portable cluster size and
    two K steps a split, only the 16-row tile splits, and the skinny FC
    layers get at least three blocks a SM (the 8-way cap keeps fc5/fc6
    at 512 blocks)."""
    m, k, n = mkn
    p = gemm_plan(m, n, k)
    assert (p.bm, p.bk, p.nsplit, p.steps) == want
    nsteps = -(-k // p.bk)
    assert (p.nsplit - 1) * p.steps < nsteps <= p.nsplit * p.steps
    assert p.nsplit <= 8 and (p.nsplit == 1 or p.steps >= 2)
    assert p.nsplit == 1 or p.bm == 16
    blocks = -(-m // p.bm) * -(-n // 64) * p.nsplit
    if m <= 16:
        assert blocks >= 3 * 132
    assert p.smem == 4 * (p.bm * p.bk + p.bk * 64) <= 48 * 1024
