"""Port parity: the AND + popcount bit-GEMM and the s8 matmul kernels'
plain versions, the faithful and MXU level-GEMM paths, the float-in
``quant_dense_kernel``, and svhn served on every ported engine.

Inputs are drawn with numpy from a seed; the JAX package's Pallas kernels
run in interpret mode, as its own tests run them on the CPU.  Tolerances:

* words, levels and int32 accumulators: exact;
* ``quant_dense_kernel``'s float output: within 1e-5 x max|output| of the
  jitted reference (measured up to 3.6e-7 here).  XLA may contract the
  epilogue into an FMA, which rounds once, and the weights are quantized
  inside the call, where the port's 1-bit scale ``2*mean|w|`` is the
  correctly rounded one while XLA's lands some ulps off it (ROADMAP
  Queue C);
* whole svhn forwards: every engine's logits equal the port's ``fused``
  logits bit for bit (the same int32 accumulators through the one shared
  epilogue), and fall within ``test_torch_forward.py``'s self-calibrated
  jit-vs-eager drift of the jitted reference, with the same argmax.

The CUDA kernels themselves run only on a card: ``test_torch_gpu.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import bitplane as jbp  # noqa: E402
from repro.core import plan as jplan_mod  # noqa: E402
from repro.core.quant import weight_levels as jweight_levels  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.bitgemm import bitgemm_packed_pallas  # noqa: E402
from repro.kernels.bitgemm_mxu import int8_matmul_pallas  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core import bitplane as bp  # noqa: E402
from repro_torch.core import plan as plan_mod  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.quant import weight_levels  # noqa: E402
from repro_torch.kernels import _lib, ops  # noqa: E402
from repro_torch.kernels.bitgemm import (bitgemm_packed,  # noqa: E402
                                         bitgemm_packed_plain, packed_plan)
from repro_torch.kernels.bitgemm_mxu import (int8_matmul,  # noqa: E402
                                             int8_matmul_plain, matmul_plan)
from repro_torch.models import cnn  # noqa: E402
from test_torch_cnn import _both_plans, _t  # noqa: E402
from test_torch_forward import _self_calibrated_tol  # noqa: E402

# (a_bits, w_bits)
PAIRS = [(1, 1), (4, 1), (8, 1), (2, 2), (3, 5), (8, 8)]
NEW_ENGINES = ["faithful", "planes", "packed", "int8", "int8_planewise",
               "f32dot"]
# shapes that are no tile multiple of either reference kernel
SHAPES = [(5, 70, 9), (70, 1000, 130), (130, 33, 65)]


def _u32(words):
    return words.numpy().view(np.uint32)


def _levels(m, k, n, ab, wb, seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 1 << ab, (m, k)).astype(np.uint8),
            rs.randint(0, 1 << wb, (k, n)).astype(np.uint8))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ab,wb", PAIRS)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_bitgemm_packed_plain_exact_vs_pallas(m, k, n, ab, wb):
    _packed_parity(m, k, n, ab, wb)


# the main path's plane word counts that are no multiple of 8: K =
# 576 (18 words a row, svhn conv1/2), 2400 (75, AlexNet conv1) and 3456
# (108, AlexNet conv3/4), at the faithful path's bit widths
@pytest.mark.parametrize("ab,wb", [(1, 1), (4, 1), (8, 1)])
@pytest.mark.parametrize("m,k,n", [(40, 576, 70), (17, 2400, 33),
                                   (9, 3456, 64)])
def test_bitgemm_packed_plain_exact_vs_pallas_at_main_path_words(m, k, n, ab,
                                                                 wb):
    assert (k // 32) % 8 != 0
    _packed_parity(m, k, n, ab, wb)


def _packed_parity(m, k, n, ab, wb):
    a, w = _levels(m, k, n, ab, wb, m + 3 * ab + wb)
    ja = jbp.decompose_packed(jnp.asarray(a).astype(jnp.int32), ab)
    jw = jbp.decompose_packed(jnp.asarray(w.T).astype(jnp.int32), wb)
    ref = np.asarray(bitgemm_packed_pallas(ja, jw, a_bits=ab, w_bits=wb,
                                           interpret=True))
    ta = bp.decompose_packed(torch.from_numpy(a), ab)
    tw = ops.pack_weight_planes(torch.from_numpy(w), wb)
    np.testing.assert_array_equal(_u32(ta), np.asarray(ja))
    np.testing.assert_array_equal(_u32(tw), np.asarray(jw))
    got = bitgemm_packed_plain(ta, tw, a_bits=ab, w_bits=wb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        ref, (a.astype(np.int64) @ w.astype(np.int64)).astype(np.int32))


@pytest.mark.parametrize("m,k,n", SHAPES + [(3, 700, 200)])
def test_int8_matmul_plain_exact_vs_pallas_signed(m, k, n):
    rs = np.random.RandomState(k)
    a = rs.randint(-128, 128, (m, k)).astype(np.int8)
    b = rs.randint(-128, 128, (k, n)).astype(np.int8)
    a[0, :] = -128                              # the most negative products
    b[:, 0] = -128
    ref = np.asarray(int8_matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                                        interpret=True))
    got = int8_matmul_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        ref, (a.astype(np.int64) @ b.astype(np.int64)).astype(np.int32))


@pytest.mark.parametrize("ab,wb", PAIRS)
def test_bitgemm_mxu_and_faithful_exact_vs_reference_ops(ab, wb):
    m, k, n = 37, 300, 70
    a, w = _levels(m, k, n, ab, wb, 5 * ab + wb)
    ja, jw = jnp.asarray(a).astype(jnp.int32), jnp.asarray(w).astype(jnp.int32)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    exact = (a.astype(np.int64) @ w.astype(np.int64)).astype(np.int32)
    ref_mxu = np.asarray(jops.bitgemm_mxu(ja, jw, ab, wb, interpret=True))
    ref_faith = np.asarray(jops.bitgemm_faithful(ja, jw, ab, wb,
                                                 interpret=True))
    np.testing.assert_array_equal(ref_mxu, exact)
    np.testing.assert_array_equal(ref_faith, exact)
    for reference in (False, True):             # CPU wrapper, plain oracle
        np.testing.assert_array_equal(
            ops.bitgemm_mxu(ta, tw, ab, wb, reference=reference).numpy(),
            ref_mxu)
        np.testing.assert_array_equal(
            ops.bitgemm_faithful(ta, tw, ab, wb, reference=reference).numpy(),
            ref_faith)
        np.testing.assert_array_equal(
            ops.bitgemm_mxu_planewise(ta, tw, ab, wb,
                                      reference=reference).numpy(), exact)
    # the faithful path with the weights packed ahead, as a plan packs them
    wp = ops.pack_weight_planes(tw, wb)
    np.testing.assert_array_equal(
        ops.bitgemm_faithful(ta, tw, ab, wb, w_planes=wp).numpy(), exact)


@pytest.mark.parametrize("ab,wb", [(1, 1), (4, 1), (8, 1), (4, 2)])
@pytest.mark.parametrize("path", ["mxu", "faithful"])
def test_quant_dense_kernel_vs_jitted_reference(path, ab, wb):
    rs = np.random.RandomState(ab * 10 + wb)
    m, k, n = 11, 300, 40
    a = rs.uniform(-0.3, 1.3, (3, m, k)).astype(np.float32)
    w = rs.normal(size=(k, n)).astype(np.float32)
    ref = np.asarray(jops.quant_dense_kernel(jnp.asarray(a), jnp.asarray(w),
                                             ab, wb, path=path))
    got = ops.quant_dense_kernel(torch.from_numpy(a), torch.from_numpy(w),
                                 ab, wb, path=path)
    assert got.shape == ref.shape == (3, m, n) and got.dtype == torch.float32
    tol = 1e-5 * float(np.abs(ref).max())
    assert float(np.abs(got.numpy() - ref).max()) <= tol
    # levels and accumulators exact: the pieces of the same call
    j_lv, j_pk = jops.quantize_pack(jnp.asarray(a.reshape(-1, k)), ab,
                                    interpret=True)
    t_lv, t_pk = ops.quantize_pack(torch.from_numpy(a.reshape(-1, k)), ab)
    np.testing.assert_array_equal(t_lv.numpy(), np.asarray(j_lv))
    np.testing.assert_array_equal(_u32(t_pk), np.asarray(j_pk))
    jw_lv = jweight_levels(jnp.asarray(w), wb)[0]
    tw_lv = weight_levels(torch.from_numpy(w), wb)[0]
    np.testing.assert_array_equal(tw_lv.numpy(), np.asarray(jw_lv))
    j_acc = bitgemm_packed_pallas(
        j_pk, jbp.decompose_packed(jw_lv.T, wb), a_bits=ab, w_bits=wb,
        interpret=True)
    t_acc = bitgemm_packed(t_pk, ops.pack_weight_planes(
        tw_lv.to(torch.uint8), wb), a_bits=ab, w_bits=wb)
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
    # both paths agree exactly
    other = ops.quant_dense_kernel(
        torch.from_numpy(a), torch.from_numpy(w), ab, wb,
        path="faithful" if path == "mxu" else "mxu", reference=True)
    assert torch.equal(got, other)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def test_bitgemm_and_int8_wrappers_on_cpu_are_plain_and_not_counted():
    a, w = _levels(9, 70, 6, 4, 1, 0)
    ta = bp.decompose_packed(torch.from_numpy(a), 4)
    tw = ops.pack_weight_planes(torch.from_numpy(w), 1)
    x = torch.from_numpy(a.astype(np.int8))
    y = torch.from_numpy(w.astype(np.int8))
    before = dict(_lib.LAUNCHES)
    assert torch.equal(bitgemm_packed(ta, tw, a_bits=4, w_bits=1),
                       bitgemm_packed_plain(ta, tw, a_bits=4, w_bits=1))
    assert torch.equal(int8_matmul(x, y), int8_matmul_plain(x, y))
    ops.quant_dense_serve(torch.from_numpy(a), torch.from_numpy(w), 0.05, 0.5,
                          a_bits=4, w_bits=1, engine="faithful")
    assert _lib.LAUNCHES == before


def test_bitgemm_and_int8_wrappers_validate_operands():
    ta = torch.zeros((4, 9, 3), dtype=torch.int32)
    tw = torch.zeros((1, 6, 3), dtype=torch.int32)
    with pytest.raises(ValueError):           # plane count != a_bits
        bitgemm_packed(ta, tw, a_bits=3, w_bits=1)
    with pytest.raises(ValueError):           # Kw differs
        bitgemm_packed(ta, tw[:, :, :2], a_bits=4, w_bits=1)
    with pytest.raises(TypeError):
        bitgemm_packed(ta.to(torch.int64), tw, a_bits=4, w_bits=1)
    with pytest.raises(ValueError):
        bitgemm_packed(ta.transpose(1, 2), tw, a_bits=4, w_bits=1)
    with pytest.raises(ValueError):           # int32 accumulator bound
        bitgemm_packed(torch.zeros((8, 1, 1100), dtype=torch.int32),
                       torch.zeros((8, 1, 1100), dtype=torch.int32),
                       a_bits=8, w_bits=8)
    x = torch.zeros((4, 8), dtype=torch.int8)
    y = torch.zeros((8, 3), dtype=torch.int8)
    with pytest.raises(TypeError):
        int8_matmul(x.to(torch.uint8), y)
    with pytest.raises(ValueError):
        int8_matmul(x, y[:7])
    with pytest.raises(ValueError):
        int8_matmul(x.t(), y[:4])
    with pytest.raises(ValueError):           # s8 partial sums past int32
        int8_matmul(torch.zeros((1, 131072), dtype=torch.int8),
                    torch.zeros((131072, 1), dtype=torch.int8))
    with pytest.raises(ValueError):
        ops.quant_dense_kernel(torch.zeros((2, 8)), torch.zeros((8, 3)), 4, 1,
                               path="planes")
    with pytest.raises(ValueError, match="unknown dense engine"):
        ops.quant_dense_serve(x.to(torch.uint8), y.to(torch.uint8)[:8], 1.0,
                              0.0, a_bits=4, w_bits=1, engine="implicit")


def test_engine_feasibility_bounds_on_cuda():
    for e in NEW_ENGINES:
        assert ops.engine_feasible(e, 8, 9216, 4096, 1, 1) == (True, "")
    ok, why = ops.engine_feasible("f32dot", 8, 300, 64, 8, 8)
    assert not ok and "mantissa" in why
    ok, why = ops.engine_feasible("int8", 1, 140000, 1, 1, 1)
    assert not ok and "s8" in why
    ok, why = ops.engine_feasible("faithful", 1, 33025, 1, 8, 8)
    assert not ok and "int32" in why
    ok, why = ops.engine_feasible("planes", 1, 64, 1, 9, 1)
    assert not ok and "uint8" in why
    assert not ops.engine_feasible("nonesuch", 1, 64, 1, 1, 1)[0]


# ---------------------------------------------------------------------------
# the slice: svhn through build -> compile -> forward on every engine
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _svhn_case(qname):
    """Reduced svhn (width 8, 16x16, batch 2): the reference's cpu plan,
    the port's plan on the same levels and scales (the default engines:
    ``fused`` at this width), an input, the jitted reference logits and
    the self-calibrated tolerance."""
    jp, tp = _both_plans(jcnn.svhn_cnn_spec(8), cnn.svhn_cnn_spec(8), qname,
                         16, 2, seed=21)
    x = np.random.RandomState(8).uniform(0, 1, (2, 16, 16, 3)).astype(
        np.float32)
    ref, tol = _self_calibrated_tol(jp, x)
    fused = plan_mod.plan_forward(tp, _t(x))
    return jp, tp, x, ref, tol, fused


@pytest.mark.parametrize("engine", NEW_ENGINES)
@pytest.mark.parametrize("qname", ["w1a1", "w1a4", "w1a8"])
def test_svhn_every_engine_equals_fused_and_the_reference(engine, qname):
    from repro_torch import api

    jp, tp, x, ref, tol, fused = _svhn_case(qname)
    assert {lp.engine for lp in tp.layers if not lp.fp} == {"fused"}
    q = dataclasses.replace(quant.PAPER_CONFIGS[qname], engine=engine)
    compiled = api.build(cnn.svhn_cnn_spec(8), q, params=tp.params,
                         img_hw=16).compile(target="cuda", batch_hints=(2,))
    assert {lp.engine for lp in compiled.plan.layers if not lp.fp} == {engine}
    assert {lp.engine_source for lp in compiled.plan.layers
            if not lp.fp} == {"override"}
    for lp, p in zip(compiled.plan.layers, compiled.params):
        assert ("w_planes" in p) == (engine == "faithful" and not lp.fp)
        if "w_planes" in p:
            assert torch.equal(p["w_planes"],
                               ops.pack_weight_planes(p["w_lv"], lp.w_bits))
    before = dict(_lib.LAUNCHES)
    got = compiled.forward(_t(x))
    assert _lib.LAUNCHES == before             # CPU: the plain versions
    assert torch.equal(got, fused)
    assert torch.equal(compiled.forward(_t(x), reference=True), fused)
    np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))
    assert np.abs(got.numpy() - ref).max() <= tol


def test_svhn_reference_faithful_interpret_matches_port_faithful():
    """The reference's own faithful engine (Pallas bit-GEMM in interpret
    mode, jitted) against the port's, on the same levels and scales."""
    jp, tp, x, ref, tol, fused = _svhn_case("w1a4")
    layers = tuple(lp if lp.fp else dataclasses.replace(lp, engine="faithful")
                   for lp in jplan_mod.layers_for_batch(jp, 2))
    ref_f = np.asarray(jax.jit(lambda p, v: jplan_mod.execute_cnn_layers(
        layers, p, v, jp.quant))(jp.params, x))
    q = dataclasses.replace(quant.W1A4, engine="faithful")
    port = plan_mod.plan_forward(plan_mod.compile_model(
        tp.params, cnn.svhn_cnn_spec(8), q, batch_hints=(2,), img_hw=16),
        _t(x))
    np.testing.assert_array_equal(port.numpy().argmax(-1), ref_f.argmax(-1))
    assert np.abs(port.numpy() - ref_f).max() <= tol
    assert np.abs(ref_f - ref).max() <= tol


# ---------------------------------------------------------------------------
# the CPU copies of the two kernels' launch plans (the card's tests hold
# each equal to the plan its .cu file exports)
# ---------------------------------------------------------------------------

SMEM_MAX = 232448   # dynamic shared memory an H100 block may use
# batch-8 GEMM views (M, K, N) of the faithful path and the activation
# widths it runs them at (svhn W1A1 and W1A4, AlexNet W1A1)
BIT_MAIN = [((12800, 576, 64), (1, 4)), ((12800, 576, 128), (1, 4)),
            ((3200, 1152, 128), (1, 4)), ((3200, 1152, 256), (1, 4)),
            ((800, 2304, 256), (1, 4)), ((800, 256, 512), (1, 4)),
            ((6272, 2400, 256), (1,)), ((1568, 2304, 384), (1,)),
            ((1568, 3456, 384), (1,)), ((1568, 3456, 256), (1,)),
            ((8, 9216, 4096), (1,)), ((8, 4096, 4096), (1,))]
# the int8 path's: svhn conv1-6 and AlexNet fc5/fc6
INT8_MAIN = [mkn for mkn, _ in BIT_MAIN[:6]] + [(8, 9216, 4096),
                                                 (8, 4096, 4096)]


def _with_skinny_rows(shapes):
    """Each shape as it is and with M = 1, 8 and 33."""
    return sorted({(mm, k, n) for m, k, n in shapes
                   for mm in (m, 1, 8, 33)})


def _check_split(nsplit, steps, nsteps, bm):
    assert 1 <= nsplit <= 8                     # portable cluster size
    assert (nsplit - 1) * steps < nsteps <= nsplit * steps   # none empty
    assert nsplit == 1 or steps >= (2 if bm == 16 else 4)


@pytest.mark.parametrize("m,k,n", _with_skinny_rows(INT8_MAIN))
def test_int8_matmul_plan_covers_the_main_path_shapes(m, k, n):
    p = matmul_plan(m, n, k)
    assert p.bm == (16 if m <= 32 else 64)
    assert -(-m // p.bm) * p.bm >= m and -(-n // 64) * 64 >= n
    nsteps = max(1, -(-k // p.bk))
    _check_split(p.nsplit, p.steps, nsteps, p.bm)
    # the kernel sets no shared-memory attribute: 48 KB at most, and the
    # split's int32 partial tile fits in the drained ring
    assert p.smem == 4 * (p.bm * p.bk + p.bk * 64) <= 48 * 1024 <= SMEM_MAX
    assert p.smem >= p.bm * 68 * 4
    if m <= 16 and k >= 4096:                   # fc5/fc6: >= 3 blocks a SM
        assert -(-n // 64) * p.nsplit >= 3 * 132


@pytest.mark.parametrize("m,k,n,ab", [
    (mm, k, n, ab) for (m, k, n), abs_ in BIT_MAIN
    for mm in sorted({m, 1, 8, 33}) for ab in abs_])
def test_bitgemm_packed_plan_covers_the_main_path_shapes(m, k, n, ab):
    kw = -(-k // 32)
    p = packed_plan(m, n, kw, ab, 1)
    assert p.bm == 16 if m <= 32 else p.bm in (32, 64)
    assert p.bm < 64 or (ab == 1 and -(-m // 64) * -(-n // 64) >= 2 * 132)
    assert -(-m // p.bm) * p.bm >= m and -(-n // 64) * 64 >= n
    nsteps = max(1, -(-kw // 16))
    _check_split(p.nsplit, p.steps, nsteps, p.bm)
    stage = (ab * p.bm + 64) * 64
    assert 2 <= p.nst <= 4
    assert p.nst * stage <= p.smem <= SMEM_MAX
    assert p.nsplit == 1 or p.smem >= p.bm * 68 * 4
    # every width up to 8 x 8 still fits a ring of at least two stages
    assert packed_plan(m, n, kw, 8, 8).nst >= 2
