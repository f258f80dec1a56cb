"""Port parity: bit planes, the five level-GEMM engines and the fused
quantize + pack kernel's plain version.

Inputs are drawn with numpy from a seed and given to the JAX package's
function and its counterpart in ``repro_torch``.  Tolerances:

* bit planes, packed words, levels and int32 accumulators: exact (the
  port's int32 words are compared with the reference's uint32 words
  through ``.view(np.uint32)``);
* ``quant_dense_pre_levels``: exact through pinned scales (``s_w =
  2^a_bits - 1``, ``z_w = 0``: the f32 output then IS the accumulator);
  with a real scale within rtol = atol = 1e-5 of the jitted reference
  (XLA may contract the epilogue into an FMA, which rounds once).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import and_accum as jaa  # noqa: E402
from repro.core import bitplane as jbp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.quantpack import quantize_pack_pallas  # noqa: E402
from repro_torch.core import and_accum as aa  # noqa: E402
from repro_torch.core import bitplane as bp  # noqa: E402
from repro_torch.kernels import _lib, ref  # noqa: E402
from repro_torch.kernels.quantpack import (quantize_pack,  # noqa: E402
                                           quantize_pack_plain)

KS = [1, 31, 32, 33, 100]
# (w_bits, a_bits): the paper's W1A1, W1A4, W1A8, W2A2, and 8x8 (both
# operands nibble-split on the int8 engine)
BITS = [(1, 1), (1, 4), (1, 8), (2, 2), (8, 8)]
ENGINES = ["planes", "packed", "int8", "int8_planewise", "f32dot"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _u32(words: torch.Tensor) -> np.ndarray:
    assert words.dtype == torch.int32
    return words.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# core/bitplane.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("k", KS)
def test_bitplane_functions_bit_exact(bits, k):
    rs = np.random.RandomState(100 * bits + k)
    lv = rs.randint(0, 1 << bits, (3, k)).astype(np.int32)
    jl, tl = jnp.asarray(lv), torch.from_numpy(lv)

    planes = bp.decompose(tl, bits)
    np.testing.assert_array_equal(planes.numpy(),
                                  np.asarray(jbp.decompose(jl, bits)))
    np.testing.assert_array_equal(bp.compose(planes).numpy(), lv)
    padded = bp.pad_to_lane(tl)
    np.testing.assert_array_equal(padded.numpy(),
                                  np.asarray(jbp.pad_to_lane(jl)))
    packed = bp.pack_bits(bp.decompose(padded, bits))
    np.testing.assert_array_equal(
        _u32(packed), np.asarray(jbp.pack_bits(jbp.decompose(
            jbp.pad_to_lane(jl), bits))))
    np.testing.assert_array_equal(bp.unpack_bits(packed, k=k).numpy(),
                                  planes.numpy())
    np.testing.assert_array_equal(
        _u32(bp.decompose_packed(tl, bits)),
        np.asarray(jbp.decompose_packed(jl, bits)))
    # packed along the leading axis (the weights' K axis)
    np.testing.assert_array_equal(
        _u32(bp.decompose_packed(tl.T.contiguous(), bits, axis=0)),
        np.asarray(jbp.decompose_packed(jl.T, bits, axis=0)))


def test_popcount_and_words_cover_the_sign_bit():
    rs = np.random.RandomState(0)
    w = rs.randint(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    t = torch.from_numpy(w.view(np.int32))
    np.testing.assert_array_equal(bp.popcount(t).numpy(),
                                  np.asarray(jbp.popcount(jnp.asarray(w))))
    np.testing.assert_array_equal(bp.from_words(t).numpy(),
                                  w.astype(np.int64))
    assert torch.equal(bp.to_words(bp.from_words(t)), t)
    # an all-ones 32-lane plane packs into the word with bit 31 set
    ones = bp.pack_bits(torch.ones((2, 32), dtype=torch.int32))
    np.testing.assert_array_equal(_u32(ones), [[0xFFFFFFFF]] * 2)
    with pytest.raises(ValueError):
        bp.pack_bits(torch.ones((2, 33), dtype=torch.int32))


# ---------------------------------------------------------------------------
# core/and_accum.py: the five engines
# ---------------------------------------------------------------------------

def _levels(m, k, n, wb, ab, seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 1 << ab, (m, k)).astype(np.int32),
            rs.randint(0, 1 << wb, (k, n)).astype(np.int32))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("wb,ab", BITS)
@pytest.mark.parametrize("m,k,n", [(5, 70, 9), (17, 33, 40)])
def test_engines_exact_vs_reference(engine, wb, ab, m, k, n):
    a, w = _levels(m, k, n, wb, ab, m + 13 * ab + wb)
    ref = np.asarray(getattr(jaa, f"bitgemm_{engine}")(
        jnp.asarray(a), jnp.asarray(w), ab, wb))
    exact = (a.astype(np.int64) @ w.astype(np.int64)).astype(np.int32)
    np.testing.assert_array_equal(ref, exact)
    for dtype in (torch.int32, torch.uint8):   # serve levels are uint8
        got = aa.bitgemm(torch.from_numpy(a).to(dtype),
                         torch.from_numpy(w).to(dtype), ab, wb, engine)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), exact)


@pytest.mark.parametrize("bits", [1, 4, 7, 8])
def test_nibble_split_matches_reference(bits):
    lv = np.random.RandomState(bits).randint(0, 1 << bits, (6, 11)).astype(
        np.int32)
    got = aa._nibble_split(torch.from_numpy(lv), bits)
    ref = jaa._nibble_split(jnp.asarray(lv), bits)
    assert [s for _, s in got] == [s for _, s in ref]
    for (g, _), (r, _) in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert int(g.max()) < 128               # an int8 operand


def test_f32dot_raises_where_the_reference_raises():
    for k, ab, wb in ((300, 8, 8), (70000, 8, 1), (2 ** 24, 1, 1)):
        assert aa.f32dot_exact(k, ab, wb) == jaa.f32dot_exact(k, ab, wb)
        assert not aa.f32dot_exact(k, ab, wb)
    a = np.ones((2, 300), np.int32)
    w = np.ones((300, 3), np.int32)
    with pytest.raises(ValueError, match="mantissa"):
        jaa.bitgemm_f32dot(jnp.asarray(a), jnp.asarray(w), 8, 8)
    with pytest.raises(ValueError, match="mantissa"):
        aa.bitgemm_f32dot(torch.from_numpy(a), torch.from_numpy(w), 8, 8)
    # just inside the bound both are exact
    k = 258                                   # 255 * 255 * 258 < 2^24
    a = np.full((2, k), 255, np.int32)
    w = np.full((k, 3), 255, np.int32)
    np.testing.assert_array_equal(
        aa.bitgemm_f32dot(torch.from_numpy(a), torch.from_numpy(w), 8, 8)
        .numpy(), np.asarray(jaa.bitgemm_f32dot(jnp.asarray(a),
                                                jnp.asarray(w), 8, 8)))


def test_packed_engine_chunks_rows(monkeypatch):
    """The AND intermediate is taken a block of rows at a time; chunking
    changes nothing."""
    a, w = _levels(37, 100, 11, 2, 3, 5)
    whole = aa.bitgemm_packed(torch.from_numpy(a), torch.from_numpy(w), 3, 2)
    monkeypatch.setattr(aa, "_AND_CHUNK", 11 * 4 * 5)    # 5 rows per block
    chunked = aa.bitgemm_packed(torch.from_numpy(a), torch.from_numpy(w), 3, 2)
    assert torch.equal(whole, chunked)
    np.testing.assert_array_equal(whole.numpy(), a @ w)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("wb,ab", [(1, 1), (1, 4), (1, 8), (2, 2)])
def test_quant_dense_pre_levels_vs_reference(engine, wb, ab):
    m, k, n = 13, 90, 21
    a, w = _levels(m, k, n, wb, ab, 7 * ab + wb)
    pinned = (np.float32((1 << ab) - 1), np.float32(0.0))
    ref = np.asarray(jaa.quant_dense_pre_levels(
        jnp.asarray(a), jnp.asarray(w), *pinned, ab, wb, engine=engine))
    got = aa.quant_dense_pre_levels(torch.from_numpy(a).to(torch.uint8),
                                    torch.from_numpy(w).to(torch.uint8),
                                    *pinned, ab, wb, engine=engine)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), (a @ w).astype(np.float32))
    s_w = np.float32(np.random.RandomState(ab).uniform(0.01, 0.1))
    z_w = np.float32(0.5 if wb == 1 else ((1 << wb) - 1) / 2.0)
    ref = np.asarray(jax.jit(lambda x, y: jaa.quant_dense_pre_levels(
        x, y, s_w, z_w, ab, wb, engine=engine))(a, w))
    got = aa.quant_dense_pre_levels(torch.from_numpy(a), torch.from_numpy(w),
                                    s_w, z_w, ab, wb, engine=engine)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


# ---------------------------------------------------------------------------
# kernels/quantpack.py (plain version) and kernels/ref.py
# ---------------------------------------------------------------------------

def _activations(m, k, bits, seed):
    """Uniform values past both ends of [0, 1], a row on the exact .5
    grid of ``bits`` (every level is a rounding tie) and a row of exact
    levels."""
    rs = np.random.RandomState(seed)
    n = (1 << bits) - 1
    a = rs.uniform(-0.3, 1.3, (m, k)).astype(np.float32)
    a[0] = ((rs.randint(0, n + 1, k) + 0.5) / n).astype(np.float32)
    a[1, : k // 2] = 0.5                        # a*n = n/2: a tie for odd n
    a[2] = (rs.randint(0, n + 1, k) / n).astype(np.float32)
    return a


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("m,k", [(5, 70), (3, 33), (4, 1), (7, 512)])
def test_quantize_pack_plain_exact_vs_pallas_and_ref(bits, m, k):
    a = _activations(m, k, bits, 10 * bits + k)
    j_lv, j_pk = quantize_pack_pallas(jnp.asarray(a), bits=bits,
                                      interpret=True)
    r_lv, r_pk = jref.quantpack_ref(jnp.asarray(a), bits)
    lv, pk = quantize_pack_plain(torch.from_numpy(a), bits)
    assert lv.dtype == torch.uint8 and pk.shape == (bits, m, -(-k // 32))
    for ref_lv, ref_pk in ((j_lv, j_pk), (r_lv, r_pk)):
        np.testing.assert_array_equal(lv.numpy().astype(np.int32),
                                      np.asarray(ref_lv))
        np.testing.assert_array_equal(_u32(pk), np.asarray(ref_pk))
    # the port's own oracle, and the levels-in form on the same levels
    t_lv, t_pk = ref.quantpack_ref(torch.from_numpy(a), bits)
    np.testing.assert_array_equal(t_lv.numpy(), np.asarray(r_lv))
    assert torch.equal(t_pk, pk)
    lv2, pk2 = quantize_pack_plain(lv, bits)
    assert lv2 is lv and torch.equal(pk2, pk)


def test_ref_oracles_match_the_reference():
    a, w = _levels(9, 45, 6, 2, 3, 1)
    np.testing.assert_array_equal(
        ref.bitgemm_ref(torch.from_numpy(a), torch.from_numpy(w), 3, 2)
        .numpy(), np.asarray(jref.bitgemm_ref(jnp.asarray(a), jnp.asarray(w),
                                              3, 2)))
    rs = np.random.RandomState(2)
    x = rs.randint(-128, 128, (7, 40)).astype(np.int8)
    y = rs.randint(-128, 128, (40, 5)).astype(np.int8)
    np.testing.assert_array_equal(
        ref.matmul_ref(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jref.matmul_ref(jnp.asarray(x), jnp.asarray(y))))
    xf = rs.uniform(-1, 1, (7, 40)).astype(np.float32)
    yf = rs.uniform(-1, 1, (40, 5)).astype(np.float32)
    np.testing.assert_allclose(
        ref.matmul_ref(torch.from_numpy(xf), torch.from_numpy(yf)).numpy(),
        np.asarray(jref.matmul_ref(jnp.asarray(xf), jnp.asarray(yf))), **TOL)


def test_quantize_pack_wrapper_cpu_is_plain_and_not_counted():
    a = torch.from_numpy(_activations(6, 40, 4, 3))
    before = dict(_lib.LAUNCHES)
    got, want = quantize_pack(a, 4), quantize_pack_plain(a, 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _lib.LAUNCHES == before
    with pytest.raises(TypeError):
        quantize_pack(a.to(torch.float64), 4)
    with pytest.raises(TypeError):
        quantize_pack(a.to(torch.int32), 4)
    with pytest.raises(ValueError):
        quantize_pack(a[0], 4)
    with pytest.raises(ValueError):
        quantize_pack(a.t(), 4)                 # not contiguous
    with pytest.raises(ValueError):
        quantize_pack(a, 9)
