"""The port's quantized attention (``repro_torch.kernels.attn_flash``) held
against the reference's (``repro.kernels.attn_flash``) on the CPU.

* Integers exactly, against the *jitted* reference: the flash q/k levels
  and per-tensor scales, the per-slot paged scales.
* Attention outputs within 1e-5 x max|v| of ``attn_flash_xla`` /
  ``attn_paged_xla`` and of ``attn_flash_pallas(interpret=True)``: the
  logits are the same integers times the same scale; the versions differ
  only in the order of the exp and the sums over blocks.
* Paged rows whose query position is -1 see every key masked;
  ``attn_paged_xla`` softmaxes them to the mean of the gathered V, and so
  do the port's plain version and CUDA kernel (valid and invalid rows
  are compared separately below).
* ``attn_paged_pallas`` cannot run on this JAX: its index maps take the
  scalar-prefetch ref first, Pallas passes it last (ROADMAP Queue C).
  One test pins that raise, so a repair of the reference shows up.

The dispatch entries take their plain versions here (CPU tensors); the
CUDA kernels are held against the same plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.api import targets as jtargets  # noqa: E402
from repro.kernels import attn_flash as JA  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.api import targets  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import attn_flash as A  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = 1e-5  # x max|v|


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, v, what=""):
    tol = TOL * float(np.abs(np.asarray(v, np.float32)).max())
    d = float(np.abs(np.asarray(got, np.float32)
                     - np.asarray(ref, np.float32)).max())
    assert d <= tol, f"{what}: max abs diff {d} > {tol}"


def _qkv(seed, b, s, h, hd, skv=None):
    rs = np.random.RandomState(seed)
    skv = skv or s
    return (rs.randn(b, s, h, hd).astype(np.float32),
            rs.randn(b, skv, h, hd).astype(np.float32),
            rs.randn(b, skv, h, hd).astype(np.float32))


# ---------------------------------------------------------------------------
# levels and scales: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8])
def test_flash_levels_and_scale_exact(dtype, bits):
    x = np.random.RandomState(bits).randn(2, 17, 3, 32).astype(np.float32) * 3
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))

    def ref(a):
        s, z = JA.attn_quant_scale(a, bits)
        return s, JA._levels(a, s, bits)

    js, jl = jax.jit(ref)(jx)
    ts, z = A.attn_quant_scale(tx, bits)
    assert z == float(1 << (bits - 1))
    assert ts.dtype == torch.float32 and float(ts) == float(js)
    np.testing.assert_array_equal(A._levels(tx, ts, bits).numpy(),
                                  np.asarray(jl))


def test_flash_exactness_bound_and_error_bound():
    for hd in (32, 64, 128, 1023, 1024):
        assert A.flash_levels_exact(hd, 8, 8) == JA.flash_levels_exact(hd, 8, 8)
    q, k, _ = _qkv(0, 1, 8, 2, 32)
    assert A.flash_error_bound(_t(q), _t(k), 8, 8) == pytest.approx(
        JA.flash_error_bound(jnp.asarray(q), jnp.asarray(k), 8, 8), rel=1e-6)


def test_paged_slot_scales_exact():
    q, pool_k, _, ppos, table, _ = _paged_inputs(3, b=3, s=2)
    js_q, js_k = jax.jit(JA._paged_slot_scales, static_argnums=4)(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(ppos),
        jnp.asarray(table), 8)
    ts_q, ts_k = A._paged_slot_scales(_t(q), _t(pool_k), _t(ppos),
                                      _t(table).long(), 8)
    np.testing.assert_array_equal(ts_q.numpy(), np.asarray(js_q))
    np.testing.assert_array_equal(ts_k.numpy(), np.asarray(js_k))


@pytest.mark.parametrize("n_q,hp,hkv", [(15, 15, 5), (3, 3, 1), (6, 8, 2)])
def test_paged_expand_idx_equal(n_q, hp, hkv):
    np.testing.assert_array_equal(A._paged_expand_idx(n_q, hp, hkv).numpy(),
                                  np.asarray(JA._paged_expand_idx(n_q, hp, hkv)))


# ---------------------------------------------------------------------------
# flash: plain version against attn_flash_xla and the Pallas kernel
# ---------------------------------------------------------------------------

FLASH_CASES = [  # (b, s, h, hd, causal, window, block)
    (1, 64, 2, 32, True, None, 16),
    (2, 40, 3, 32, True, None, 16),
    (1, 48, 2, 64, False, None, 16),
    (2, 64, 3, 32, True, 10, 16),
    (1, 33, 1, 32, True, None, 512),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_plain_matches_xla(case):
    b, s, h, hd, causal, window, blk = case
    q, k, v = _qkv(sum(case[:4]), b, s, h, hd)
    ref = JA.attn_flash_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window, block_q=blk,
                            block_kv=blk)
    got = A.attn_flash_plain(_t(q), _t(k), _t(v), causal=causal,
                             window=window, block_q=blk, block_kv=blk)
    _close(got.numpy(), ref, v, "flash vs xla")


@pytest.mark.parametrize("window", [None, 16])
def test_flash_plain_matches_pallas_interpret(window):
    q, k, v = _qkv(7, 1, 64, 2, 32)
    ref = JA.attn_flash_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, window=window, block_q=16,
                               block_kv=16, interpret=True)
    got = A.attn_flash_plain(_t(q), _t(k), _t(v), causal=True, window=window,
                             block_q=16, block_kv=16)
    _close(got.numpy(), ref, v, "flash vs pallas interpret")


def test_flash_plain_bf16_matches_xla():
    q, k, v = _qkv(9, 2, 32, 3, 32)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    ref = JA.attn_flash_xla(jq, jk, jv, causal=True, block_q=16, block_kv=16)
    tq, tk, tv = (_t(np.asarray(a.astype(jnp.float32))).bfloat16()
                  for a in (jq, jk, jv))
    got = A.attn_flash_plain(tq, tk, tv, causal=True, block_q=16, block_kv=16)
    assert got.dtype == torch.bfloat16
    # one bf16 ulp of the output on top of the f32 tolerance
    d = np.abs(got.float().numpy() - np.asarray(ref.astype(jnp.float32)))
    assert d.max() <= 2 ** -7 * np.abs(v).max()


def test_flash_dispatch_on_cpu_is_the_plain_version():
    q, k, v = _qkv(1, 1, 24, 2, 32)
    _lib.reset_launches()
    a = A.attn_flash(_t(q), _t(k), _t(v), causal=True)
    b = A.attn_flash(_t(q), _t(k), _t(v), causal=True, reference=True)
    c = A.attn_flash_plain(_t(q), _t(k), _t(v), causal=True)
    assert torch.equal(a, c) and torch.equal(b, c)
    assert _lib.LAUNCHES["attn_flash"] == 0


def test_flash_rejects_inexact_head_dim():
    q = torch.zeros((1, 2, 1, 1024))
    with pytest.raises(ValueError):
        A.attn_flash_plain(q, q, q)


# ---------------------------------------------------------------------------
# paged: plain version against attn_paged_xla
# ---------------------------------------------------------------------------

def _paged_inputs(seed, *, b=3, s=1, hp=3, hkv=1, hd=32, ps=4, np_=10, p=4):
    """Pools with stale content everywhere, ragged page tables padded with
    the null page, ppos written only for each slot's live positions, and
    query rows at those positions (the last row of slot 0 padding, -1)."""
    rs = np.random.RandomState(seed)
    pool_k = rs.randn(np_ + 1, ps, hkv, hd).astype(np.float32)
    pool_v = rs.randn(np_ + 1, ps, hkv, hd).astype(np.float32)
    pool_k[np_] = 0.0
    pool_v[np_] = 0.0
    ppos = np.full((np_ + 1, ps), -1, np.int32)
    table = np.full((b, p), np_, np.int32)
    q_pos = np.full((b, s), -1, np.int32)
    pages = list(rs.permutation(np_))
    for i in range(b):
        n_tok = int(rs.randint(s, p * ps - 1))     # tokens already written
        own = [pages.pop() for _ in range(-(-n_tok // ps))]
        table[i, :len(own)] = own
        for t in range(n_tok):
            ppos[own[t // ps], t % ps] = t
        q_pos[i] = np.arange(n_tok - s, n_tok)
    q_pos[0, -1] = -1
    q = rs.randn(b, s, hp, hd).astype(np.float32)
    return q, pool_k, pool_v, ppos, table, q_pos


PAGED_CASES = [  # (seed, s, hp, hkv, quantized, window)
    (0, 1, 3, 1, True, None),
    (1, 4, 3, 1, True, None),
    (2, 4, 6, 2, True, None),
    (3, 2, 15, 5, True, None),
    (4, 4, 3, 1, True, 5),
    (5, 4, 3, 1, False, None),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: "-".join(map(str, c)))
def test_paged_plain_matches_xla(case, dtype):
    """float32, and bfloat16 as the LM main path runs ``attn_paged``: both
    versions get the same bf16 inputs (``attn_paged_xla`` in jnp.bfloat16,
    the plain version in torch.bfloat16) and return bf16.  bf16 tolerance:
    one output rounding, 2^-7 x max|v| (as the flash bf16 test), on top of
    the float32 one; a probe over these six cases found 0 differing
    elements, padding rows included."""
    seed, s, hp, hkv, quantized, window = case
    q, pk, pv, pp, tbl, qp = _paged_inputs(seed, s=s, hp=hp, hkv=hkv)
    kw = dict(causal=True, window=window, quantized=quantized, n_q_heads=hp)
    if dtype == "bfloat16":
        jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, pk, pv))
        q, pk, pv = (np.asarray(a.astype(jnp.float32)) for a in (jq, jk, jv))
        ref = JA.attn_paged_xla(jq, jk, jv, jnp.asarray(pp), jnp.asarray(tbl),
                                jnp.asarray(qp), **kw)
        assert ref.dtype == jnp.bfloat16
        ref = np.asarray(ref.astype(jnp.float32))
        got = A.attn_paged_plain(*(_t(a).bfloat16() for a in (q, pk, pv)),
                                 _t(pp), _t(tbl), _t(qp), **kw)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        tol = TOL + 2.0 ** -7
    else:
        ref = np.asarray(JA.attn_paged_xla(
            jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(pp),
            jnp.asarray(tbl), jnp.asarray(qp), **kw))
        got = A.attn_paged_plain(_t(q), _t(pk), _t(pv), _t(pp), _t(tbl),
                                 _t(qp), **kw).numpy()
        tol = TOL
    vmax = float(np.abs(pv).max())

    def close(a, b, what):
        d = float(np.abs(a - b).max())
        assert d <= tol * vmax, f"{dtype} {what}: max abs diff {d}"

    valid = qp >= 0
    close(got[valid], ref[valid], "valid rows")
    # invalid rows: both give the mean of the gathered V
    close(got[~valid], ref[~valid], "invalid rows")
    gathered = pv[tbl[0]].reshape(-1, hkv, pv.shape[-1]).mean(0)
    idx = A._paged_expand_idx(hp, hp, hkv).numpy()
    close(got[0, -1], gathered[idx], "invalid row = mean of V")


def test_paged_dispatch_on_cpu_is_the_plain_version():
    q, pk, pv, pp, tbl, qp = _paged_inputs(8, s=2)
    args = [_t(a) for a in (q, pk, pv, pp, tbl, qp)]
    _lib.reset_launches()
    a = A.attn_paged(*args, quantized=True, n_q_heads=3)
    b = A.attn_paged(*args, quantized=True, n_q_heads=3, reference=True)
    c = A.attn_paged_plain(*args, quantized=True, n_q_heads=3)
    assert torch.equal(a, c) and torch.equal(b, c)
    assert _lib.LAUNCHES["attn_paged"] == 0


def test_reference_paged_pallas_index_map_fault_pinned():
    """``attn_paged_pallas`` (attn_flash.py:587-595) writes its index maps
    ``lambda tbl, b, p``; Pallas passes the grid indices first, so ``tbl``
    arrives as the 0-d grid index and indexing it raises.  When the
    reference is repaired this test fails: hold the port's kernel against
    it then."""
    q, pk, pv, pp, tbl, qp = _paged_inputs(0, b=2, s=1)
    with pytest.raises(IndexError, match="0-dimensional"):
        JA.attn_paged_pallas(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                             jnp.asarray(pp), jnp.asarray(tbl),
                             jnp.asarray(qp), n_q_heads=3, interpret=True)


# ---------------------------------------------------------------------------
# the attention dispatch table
# ---------------------------------------------------------------------------

SHAPES = [  # AttnShape kwargs the reference's TPU target and the port share
    dict(seq_q=2048, seq_kv=2048, heads=15, head_dim=64, quantized=True),
    dict(seq_q=2047, seq_kv=2047, heads=15, head_dim=64, quantized=True),
    dict(seq_q=4096, seq_kv=4096, heads=15, head_dim=64, quantized=True),
    dict(seq_q=1, seq_kv=2064, heads=15, head_dim=64, quantized=True),
    dict(seq_q=16, seq_kv=288, heads=15, head_dim=64, quantized=True,
         page_size=16),
    dict(seq_q=1, seq_kv=288, heads=15, head_dim=64, quantized=False,
         page_size=16),
    dict(seq_q=512, seq_kv=512, heads=4, head_dim=32, quantized=False),
    # the reference's chunked and banded geometries
    dict(seq_q=8192, seq_kv=8192, heads=4, head_dim=32, quantized=False),
    dict(seq_q=300, seq_kv=300, heads=4, head_dim=32, window=64,
         quantized=False),
]


@pytest.mark.parametrize("kw", SHAPES, ids=lambda k: f"{k['seq_q']}-{k.get('page_size')}-{k['quantized']}")
def test_cuda_attn_engine_equals_tpu_table(kw):
    want = jtargets.get_target("tpu").select_attn_engine(jops.AttnShape(**kw))
    assert ops.select_attn_engine(ops.AttnShape(**kw)) == want
    assert ops.attn_engine_feasible(want, ops.AttnShape(**kw))[0]


@pytest.mark.parametrize("kw", [
    dict(seq_q=8192, seq_kv=8192, heads=4, head_dim=32),
    dict(seq_q=300, seq_kv=300, heads=4, head_dim=32, window=64),
])
def test_chunked_and_banded_geometries_raise(kw):
    """These geometries raised while the chunked and banded engines were
    not ported; they now resolve as the reference's TPU target resolves
    them, to an engine the port can run, and no longer raise."""
    attn = ops.AttnShape(**kw)
    eng = ops.select_attn_engine(attn)
    assert eng == jtargets.get_target("tpu").select_attn_engine(
        jops.AttnShape(**kw))
    assert eng == ("banded" if kw.get("window") else "chunked")
    assert ops.attn_engine_feasible("chunked", attn) == (True, "")
    assert ops.attn_engine_feasible("banded", attn)[0] == bool(
        kw.get("window"))


def test_flash_threshold_is_the_module_constant(monkeypatch):
    shape = ops.AttnShape(seq_q=64, seq_kv=64, heads=3, head_dim=32,
                          quantized=True)
    assert ops.select_attn_engine(shape) == "full"
    monkeypatch.setattr(targets, "ATTN_FLASH_SEQ_MIN", 64)
    assert ops.select_attn_engine(shape) == "flash"


def test_paged_bounds_are_the_kernels_shared_memory():
    ok, _ = ops.paged_attn_bounds(ops.AttnShape(
        seq_q=16, seq_kv=288, heads=15, head_dim=64, page_size=16))
    assert ok
    # a block serves one query head's rows once they pass 16, so the rows
    # a block holds grow with the chunk length: 256 rows of hd 128 do not
    # fit its shared memory
    bad = ops.AttnShape(seq_q=256, seq_kv=256, heads=32, head_dim=128,
                        page_size=16)
    ok, why = ops.paged_attn_bounds(bad)
    assert not ok and "shared memory" in why
    assert A.paged_smem_bytes(256, 128) > A.SMEM_LIMIT
    # the layout (float32 pools, the bound's worst case): 138 rows of
    # hd 128 fit a block, 139 do not
    assert A.paged_smem_bytes(138, 128) <= A.SMEM_LIMIT
    assert A.paged_smem_bytes(139, 128) > A.SMEM_LIMIT
    assert ops.paged_attn_bounds(ops.AttnShape(
        seq_q=138, seq_kv=256, heads=5, head_dim=128, page_size=16))[0]
    assert not ops.paged_attn_bounds(ops.AttnShape(
        seq_q=139, seq_kv=256, heads=5, head_dim=128, page_size=16))[0]
    assert not ops.paged_attn_bounds(ops.AttnShape(
        seq_q=1, seq_kv=30, heads=4, head_dim=32, page_size=16))[0]
    # the kernel's own grouping: 15 query heads over 5 KV heads -> 3 each
    assert A.paged_group_heads(15, 5, 15) == 3
    assert A.paged_group_heads(8, 2, 6) == 5


@pytest.mark.parametrize("nh,s,want", [
    (3, 1, 3),      # decode: a KV head's 3 query heads share its pages
    (3, 16, 1),     # a 16-row prefill chunk: a block per query head
    (3, 5, 3), (3, 6, 2), (32, 1, 16), (1, 64, 1)])
def test_paged_heads_per_block(nh, s, want):
    assert A.paged_heads_per_block(nh, s) == want


def test_paged_smem_bytes_is_the_kernels_layout():
    # the main path's prefill chunk in bf16: 3 query heads x 16 rows
    rows, hd = 48, 64
    assert A.paged_smem_bytes(rows, hd, 2) == (
        2 * 2 * 64 * hd * 2         # raw K and V tiles, double-buffered
        + 2 * 64 * 4                # their positions
        + 64 * (hd + 16)            # the tile's K levels, padded rows
        + rows * (hd + 16)          # q levels
        + 4 * rows * hd             # accumulators
        + 8 * rows)                 # m, l
    assert A.paged_smem_bytes(rows, hd, 2) < A.paged_smem_bytes(rows, hd, 4)


def test_inv_sqrt_is_the_float32_reciprocal_of_the_float32_root():
    for hd in A.KERNEL_HEAD_DIMS:
        want = np.float32(1.0) / np.float32(np.sqrt(hd))
        assert A._inv_sqrt(hd) == float(want)


_BASE = torch.zeros(64, dtype=torch.float32)


@pytest.mark.parametrize("x,index,err", [
    (_BASE[:32].view(2, 16).t(), False, ValueError),     # not contiguous
    (_BASE[1:17], False, ValueError),                    # 4 bytes past 16
    (torch.zeros(4, dtype=torch.int64), True, TypeError),
    (torch.zeros((4, 4), dtype=torch.int32).t(), True, ValueError)])
def test_kernel_input_refuses_what_it_would_have_to_copy(x, index, err):
    """The wrappers hand a kernel its tensors as they are: a tensor the
    kernel cannot read in place raises instead of being copied."""
    with pytest.raises(err):
        A._kernel_input(x, "x", index=index)


@pytest.mark.parametrize("x,index", [
    (_BASE[4:20], False),                                # 16 bytes in
    (torch.zeros((2, 3), dtype=torch.int32)[1:], True)])  # 12 bytes in
def test_kernel_input_takes_tensors_as_they_are(x, index):
    assert A._kernel_input(x, "x", index=index) == x.data_ptr()


def test_flash_feasibility_needs_quantized_prefill():
    base = dict(seq_q=2048, seq_kv=2048, heads=15, head_dim=64)
    assert not ops.attn_engine_feasible("flash", ops.AttnShape(**base))[0]
    assert not ops.attn_engine_feasible("flash", ops.AttnShape(
        **dict(base, seq_q=1), quantized=True))[0]
    assert not ops.attn_engine_feasible("flash", ops.AttnShape(
        **dict(base, head_dim=48), quantized=True))[0]
    assert ops.attn_engine_feasible("flash", ops.AttnShape(
        **base, quantized=True))[0]
    assert not ops.attn_engine_feasible("full", ops.AttnShape(
        **base, page_size=16))[0]


@pytest.mark.parametrize("hkv,nq,npad", [(5, 15, 15), (5, 15, 16),
                                         (1, 16, 16), (2, 4, 4), (4, 2, 2),
                                         (5, 7, 8), (8, 8, 8)])
def test_expand_kv_equals_reference_gather_and_is_contiguous(hkv, nq, npad):
    """GQA's KV expansion (a broadcast and a reshape, which DTensor can
    differentiate) gives the reference's ``expand_kv`` gather bit for bit,
    as contiguous tensors (the kernels refuse a stride-0 view: one KV head
    for 16 query heads, recurrentgemma's)."""
    from repro.models.layers import expand_kv as jexpand_kv
    from repro_torch.models.layers import expand_kv

    rs = np.random.RandomState(hkv * 100 + npad)
    k, v = (rs.randn(2, 3, hkv, 8).astype(np.float32) for _ in range(2))
    got = expand_kv(torch.from_numpy(k), torch.from_numpy(v), nq, npad)
    want = jexpand_kv(jnp.asarray(k), jnp.asarray(v), nq, npad)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
