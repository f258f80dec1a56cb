"""The port's LM serve path (``repro_torch`` configs, signed quantized
dense, layers, transformer, ``launch/serve``, ``LMRunner``) held against
the reference on the CPU.

Geometry: the reference's smoke config of smollm-360m with the full
model's GQA group of 3 — ``smoke(n_layers=2, d_model=64, n_heads=3,
n_kv_heads=1, d_ff=128, vocab=64, head_dim=32)`` — at W1A8, float32
compute (and bfloat16 where stated).  Params are drawn with numpy in the
reference's layout, prequantized by the reference, and carried across
with ``convert.lm_params_from_numpy``.

Tolerances:
* integers exactly (signed activation levels, int32 accumulators, weight
  levels), against the jitted reference;
* the signed dense's float output exactly: its correction terms are
  exact in float32 and both sides round the same two products;
* logits within 1e-5 x max|logit| (float32): rope's sin/cos and the
  softmax's exp differ by ulps between XLA and PyTorch;
* greedy tokens equal, for ``serve_once``, the bucket engine and the
  flash engine forced at a small S (the reference through its plan table,
  the port through its threshold).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import and_accum as jaa  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.api import targets  # noqa: E402
from repro_torch.core import and_accum as aa  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.engine import LMRunner, ServeEngine  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

GEOM = dict(n_layers=2, d_model=64, n_heads=3, n_kv_heads=1, d_ff=128,
            vocab=64, head_dim=32)
LOGIT_TOL = 1e-5  # x max|logit|


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a.astype(jnp.float32) if hasattr(a, "astype")
                      and a.dtype == jnp.bfloat16 else a)


def _numpy_params(seed: int = 0) -> dict:
    rs = np.random.RandomState(seed)
    n, d, hd = GEOM["n_layers"], GEOM["d_model"], GEOM["head_dim"]
    h, hk, ff = GEOM["n_heads"], GEOM["n_kv_heads"], GEOM["d_ff"]

    def w(*shape):
        return (rs.randn(*shape) / math.sqrt(shape[-2])).astype(np.float32)

    ones = lambda *s: np.ones(s, np.float32)  # noqa: E731
    return {"embed": (rs.randn(256, d) * 0.02).astype(np.float32),
            "final_norm": ones(d),
            "blocks": {"attn": {
                "attn": {"ln": ones(n, d), "wq": w(n, d, h * hd),
                         "wk": w(n, d, hk * hd), "wv": w(n, d, hk * hd),
                         "wo": w(n, h * hd, d)},
                "mlp": {"ln": ones(n, d), "w_in": w(n, d, ff),
                        "w_gate": w(n, d, ff), "w_out": w(n, ff, d)}}}}


@pytest.fixture(scope="module")
def lm():
    jcfg = dataclasses.replace(jconfigs.get_config("smollm-360m").smoke(**GEOM),
                               quant=jquant.PAPER_CONFIGS["w1a8"])
    cfg = dataclasses.replace(configs.get_config("smollm-360m").smoke(**GEOM),
                              quant=quant.PAPER_CONFIGS["w1a8"])
    raw = _numpy_params()
    jp = JL.prequantize_params(jax.tree.map(jnp.asarray, raw), jcfg)
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                          device="cpu")
    return dict(cfg=cfg, params=params, jcfg=jcfg, jparams=jp, raw=raw)


def _prefill_ref(lm, toks):
    fn = jax.jit(lambda p, t: JT.prefill(p, lm["jcfg"], jconfigs.SINGLE,
                                         tokens=t, qmode="serve"))
    return fn(lm["jparams"], jnp.asarray(toks))


def _logits_close(got, ref):
    ref = np.asarray(ref)
    tol = LOGIT_TOL * float(np.abs(ref).max())
    assert float(np.abs(np.asarray(got) - ref).max()) <= tol


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_smollm_config_equals_reference():
    ref, got = jconfigs.get_config("smollm-360m"), configs.get_config(
        "smollm-360m")
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "head_dim", "tie_embeddings",
              "pattern", "act", "rope_theta", "causal", "window", "qk_norm",
              "hd", "padded_vocab", "blocks_pattern"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.compute_dtype == torch.bfloat16
    assert got.param_dtype == torch.float32
    assert configs.SINGLE.padded_heads(15) == jconfigs.SINGLE.padded_heads(15)


def test_smoke_config_equals_reference_smoke():
    ref = jconfigs.get_config("smollm-360m").smoke(**GEOM)
    got = configs.get_config("smollm-360m").smoke(**GEOM)
    for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "hd", "padded_vocab", "blocks_pattern"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.compute_dtype == torch.float32
    default = configs.get_config("smollm-360m").smoke()
    assert (default.d_model, default.n_heads, default.vocab) == (128, 4, 512)


@pytest.mark.parametrize("arch,err,match", [
    ("no-such-arch", ValueError, "unknown arch")])
def test_unported_archs_raise(arch, err, match):
    """Every arch of the reference is ported; an unknown id is not an
    arch."""
    with pytest.raises(err, match=match):
        configs.get_config(arch)


# ---------------------------------------------------------------------------
# signed levels and the signed dense: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("row", [False, True])
def test_signed_activation_levels_exact(dtype, row):
    a = np.random.RandomState(3).randn(33, 96).astype(np.float32) * 2.5
    ja = jnp.asarray(a).astype(dtype)
    ta = _t(_np(ja)).to(getattr(torch, dtype))
    jfn = (jquant.activation_levels_signed_row if row
           else jquant.activation_levels_signed)
    tfn = (quant.activation_levels_signed_row if row
           else quant.activation_levels_signed)
    jl, js, jz = jax.jit(lambda x: jfn(x, 8))(ja)
    tl, ts, tz = tfn(ta, 8)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert ts.dtype == ta.dtype and tz.dtype == ta.dtype
    np.testing.assert_array_equal(ts.float().numpy(), _np(js))
    assert float(tz) == float(jz) == 128.0


@pytest.mark.parametrize("m", [1, 8, 16, 17, 64])
def test_centred_gemm_gives_the_reference_accumulator(m):
    """The centred int8 product plus 128 colsum(W) is the reference's int32
    accumulator A@W, exactly."""
    rs = np.random.RandomState(m)
    a = rs.randint(0, 256, (m, 64)).astype(np.int32)
    w = rs.randint(0, 2, (64, 40)).astype(np.int8)
    ref = jaa.bitgemm_int8(jnp.asarray(a), jnp.asarray(w).astype(jnp.int32),
                           8, 1)
    got = aa.centred_gemm_int(_t(a - 128), _t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        (got + 128 * _t(w).sum(0, dtype=torch.int32)).numpy(), np.asarray(ref))


def test_centred_gemm_rejects_unaligned_shapes():
    with pytest.raises(ValueError):
        aa.centred_gemm_int(torch.zeros((4, 12), dtype=torch.int32),
                            torch.zeros((12, 8), dtype=torch.int8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("a_scale", [None, "row", 0.03125])
def test_signed_dense_equals_reference(dtype, a_scale):
    rs = np.random.RandomState(5)
    a = rs.randn(2, 9, 64).astype(np.float32)
    w = rs.randn(64, 96).astype(np.float32)
    w_lv, s_w, z_w = jquant.weight_levels(jnp.asarray(w), 1)
    ja = jnp.asarray(a).astype(dtype)
    ref = jax.jit(lambda x, q, s, z: jaa.quant_dense_forward_signed_pre(
        x, q, s, z, 8, 1, engine="int8", a_scale=a_scale))(
        ja, w_lv.astype(jnp.int8), s_w, z_w)
    got = aa.quant_dense_forward_signed_pre(
        _t(_np(ja)).to(getattr(torch, dtype)),
        _t(np.asarray(w_lv).astype(np.int8)), torch.tensor(float(s_w)),
        torch.tensor(float(z_w)), 8, 1, a_scale=a_scale)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 9, 96)
    np.testing.assert_array_equal(got.float().numpy(), _np(ref))


def test_prequantize_params_levels_equal_reference(lm):
    cfg = lm["cfg"]
    raw = convert.lm_params_from_numpy(lm["raw"], cfg, device="cpu")
    got = L.prequantize_params(raw, cfg)
    for sub in ("attn", "mlp"):
        for k, ref in lm["params"]["blocks"]["attn"][sub].items():
            if k not in L.PREQUANT_KEYS:
                continue
            mine = got["blocks"]["attn"][sub][k]
            assert mine["q"].dtype == torch.int8
            assert torch.equal(mine["q"], ref["q"])
            assert torch.equal(mine["z"], ref["z"])
            # 2*mean|w|: the port rounds a float64 mean once, XLA's
            # float32 mean lands a few ulps off (ROADMAP Queue C)
            np.testing.assert_allclose(mine["s"].numpy(), ref["s"].numpy(),
                                       rtol=16 * 2 ** -23)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_match_reference():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 7, 3, 32).astype(np.float32)
    sc = rs.rand(32).astype(np.float32) + 0.5
    pos = np.arange(100, 107)
    ref_n = jax.jit(JL.rms_norm)(jnp.asarray(x), jnp.asarray(sc))
    np.testing.assert_allclose(L.rms_norm(_t(x), _t(sc)).numpy(), ref_n,
                               rtol=2e-6, atol=2e-6)
    ref_r = jax.jit(lambda a, p: JL.rope(a, p, 10_000.0))(jnp.asarray(x),
                                                          jnp.asarray(pos))
    np.testing.assert_allclose(L.rope(_t(x), _t(pos), 10_000.0).numpy(),
                               ref_r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_attn_full_matches_reference(window):
    rs = np.random.RandomState(4)
    q, k, v = (rs.randn(2, 12, 3, 32).astype(np.float32) for _ in range(3))
    qp = np.arange(12)
    kp = np.where(np.arange(12) < 10, np.arange(12), -1)
    ref = jax.jit(lambda a, b, c: JL.attn_full(
        a, b, c, causal=True, window=window, q_pos=jnp.asarray(qp),
        kv_pos=jnp.asarray(kp)))(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v))
    got = L.attn_full(_t(q), _t(k), _t(v), causal=True, window=window,
                      q_pos=_t(qp), kv_pos=_t(kp))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(v).max())


def test_expand_kv_is_the_gqa_head_map():
    k = torch.arange(2 * 3 * 5 * 4, dtype=torch.float32).reshape(2, 3, 5, 4)
    ek, ev = L.expand_kv(k, k, 15, 15)
    jk, _ = JL.expand_kv(jnp.asarray(k.numpy()), jnp.asarray(k.numpy()), 15,
                         15)
    np.testing.assert_array_equal(ek.numpy(), np.asarray(jk))
    assert L.expand_kv(k, k, 5, 5)[0] is k


def test_bf16_attention_layer_levels_exact(lm):
    """The card computes in bfloat16: one attention layer plus its qdenses
    in bf16.  The projections' activation levels and outputs are exact on
    the same bf16 input; the layer output agrees within one bf16 rounding
    of the softmax and P@V chain."""
    jcfg = dataclasses.replace(lm["jcfg"], compute_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(lm["cfg"], compute_dtype=torch.bfloat16)
    jp = jax.tree.map(lambda t: t[0], lm["jparams"]["blocks"]["attn"]["attn"])
    tp = T.unstack_layers(lm["params"], cfg)[0]["attn"]
    x = np.random.RandomState(6).randn(2, 10, 64).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = _t(_np(jx)).bfloat16()
    h = JL.rms_norm(jx, jp["ln"])
    th = _t(_np(h)).bfloat16()
    for name in ("wq", "wk", "wv"):
        jl = jax.jit(lambda a: jquant.activation_levels_signed(
            a.reshape(-1, 64), 8)[0])(h)
        tl = quant.activation_levels_signed(th.reshape(-1, 64), 8)[0]
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        ref = jax.jit(lambda a, w: JL.qdense(a, w, jcfg.quant, mode="serve"))(
            h, jp[name])
        got = L.qdense(th, tp[name], cfg.quant)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), _np(ref))
    ref, _ = jax.jit(lambda a, p: JL.attention_fwd(
        p, a, jcfg, jconfigs.SINGLE, mode="prefill", qmode="serve"))(jx, jp)
    got, _ = L.attention_fwd(tp, tx, cfg, configs.SINGLE, mode="prefill")
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - _np(ref))
    assert d.max() <= 2 ** -6 * np.abs(_np(ref)).max()


# ---------------------------------------------------------------------------
# the model: prefill, decode, paged step
# ---------------------------------------------------------------------------

def test_prefill_logits_and_cache_match_reference(lm):
    toks = np.random.RandomState(1).randint(0, 64, (2, 12)).astype(np.int32)
    jl, jc = _prefill_ref(lm, toks)
    tl, tc = T.prefill(lm["params"], lm["cfg"], configs.SINGLE,
                       tokens=_t(toks))
    assert tl.shape == (2, 12, 256) and tl.dtype == torch.float32
    _logits_close(tl.numpy(), jl)
    np.testing.assert_allclose(tc["attn"]["k"].numpy(), jc["attn"]["k"],
                               atol=1e-5)
    np.testing.assert_array_equal(tc["attn"]["pos"].numpy(),
                                  np.asarray(jc["attn"]["pos"]))


def test_flash_prefill_matches_reference_flash(lm, monkeypatch):
    """The flash engine at S=24: the reference takes it through an
    installed plan-table verdict, the port through its threshold."""
    s = 24
    toks = np.random.RandomState(8).randint(0, 64, (2, s)).astype(np.int32)
    key = jops.attn_plan_key(jops.AttnShape(
        seq_q=s, seq_kv=s, heads=3, head_dim=32, causal=True, window=None,
        quantized=True), "cpu")
    jops.install_plan_table({key: "flash"})
    try:
        jl, _ = _prefill_ref(lm, toks)
    finally:
        jops.clear_plan_state()
    full, _ = _prefill_ref(lm, toks)
    # the verdict took: flash's quantized scores move the logits
    assert float(np.abs(np.asarray(jl) - np.asarray(full)).max()) > 1e-3
    monkeypatch.setattr(targets, "ATTN_FLASH_SEQ_MIN", s)
    tl, _ = T.prefill(lm["params"], lm["cfg"], configs.SINGLE,
                      tokens=_t(toks))
    _logits_close(tl.numpy(), jl)


def test_decode_step_matches_reference(lm):
    toks = np.random.RandomState(2).randint(0, 64, (2, 6)).astype(np.int32)
    jl, jc = _prefill_ref(lm, toks)
    jc = jserve.grow_cache(jc, 6, 9)
    nxt = np.asarray(jserve.greedy_token(jl, 64))
    jd, _ = jax.jit(lambda p, c, t: JT.decode_step(
        p, c, t, 6, lm["jcfg"], jconfigs.SINGLE, qmode="serve"))(
        lm["jparams"], jc, jnp.asarray(nxt))
    tl, tc = T.prefill(lm["params"], lm["cfg"], configs.SINGLE,
                       tokens=_t(toks))
    tc = serve.grow_cache(tc, 6, 9)
    assert tc["attn"]["k"].shape[2] == 9
    assert (tc["attn"]["pos"][:, :, 6:] == -1).all()
    np.testing.assert_array_equal(serve.greedy_token(tl, 64).numpy(), nxt)
    td, tc = T.decode_step(lm["params"], tc, _t(nxt), 6, lm["cfg"],
                           configs.SINGLE)
    _logits_close(td.numpy(), jd)
    assert (tc["attn"]["pos"][:, :, 6] == 6).all()


def test_paged_step_matches_reference(lm):
    """A prefill chunk with padding rows: the port writes only the valid
    rows (the reference drops the rest) and attends over the pages."""
    jcfg = dataclasses.replace(lm["jcfg"], quant=dataclasses.replace(
        lm["jcfg"].quant, act_scale_mode="row"))
    cfg = dataclasses.replace(lm["cfg"], quant=dataclasses.replace(
        lm["cfg"].quant, act_scale_mode="row"))
    np_, ps, P = 6, 4, 3
    jcache = JT.init_paged_cache(jcfg, jconfigs.SINGLE, 1, np_, ps, P)
    tbl = np.array([[4, 1, np_]], np.int32)
    jcache["attn"]["table"] = jnp.broadcast_to(jnp.asarray(tbl)[None],
                                               (2, 1, P))
    toks = np.array([[5, 9, 2, 7, 0, 0]], np.int32)
    pos, valid = np.array([2], np.int32), np.array([4], np.int32)
    jl, jc = jax.jit(lambda p, c: JT.paged_step(
        p, c, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(valid), jcfg,
        jconfigs.SINGLE))(lm["jparams"], jcache)
    tcache = T.init_paged_cache(cfg, configs.SINGLE, 1, np_, ps, P)
    tcache["attn"]["table"] = _t(tbl)
    tl, tc = T.paged_step(lm["params"], tcache, _t(toks), _t(pos),
                          _t(valid), cfg, configs.SINGLE)
    _logits_close(tl.numpy()[:, :4], np.asarray(jl)[:, :4])
    np.testing.assert_array_equal(tc["attn"]["ppos"].numpy(),
                                  np.asarray(jc["attn"]["ppos"]))
    np.testing.assert_allclose(tc["attn"]["pk"].numpy(), jc["attn"]["pk"],
                               atol=1e-5)
    # the null page was never written
    assert (tc["attn"]["ppos"][:, np_] == -1).all()
    assert not tc["attn"]["pk"][:, np_].any()


# ---------------------------------------------------------------------------
# entry points: serve_once, the bucket engine, the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(lm):
    prompts = np.random.RandomState(0).randint(0, 64, (2, 8)).astype(np.int32)
    ref, _ = jserve.serve_once(lm["jparams"], lm["jcfg"], jconfigs.SINGLE,
                               jnp.asarray(prompts), 6, "serve")
    return prompts, np.asarray(ref)


def test_serve_once_tokens_equal_reference(lm, served):
    prompts, ref = served
    margins = []
    got, dt = serve.serve_once(lm["params"], lm["cfg"], configs.SINGLE,
                               _t(prompts), 6, "serve", margins=margins)
    assert dt > 0 and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(margins) == 6 and all((m >= 0).all() for m in margins)


def test_bucket_engine_tokens_equal_reference(lm, served):
    prompts, ref = served
    eng = ServeEngine(LMRunner(lm["params"], lm["cfg"], new_tokens=6),
                      max_batch=2)
    res = eng.serve(list(prompts))
    np.testing.assert_array_equal(np.stack([r.value for r in res]), ref)
    assert eng.stats["dispatches"] == 1


def _port_serve(lm, rows, new_tokens):
    got, _ = serve.serve_once(lm["params"], lm["cfg"], configs.SINGLE,
                              _t(np.stack(rows)), new_tokens, "serve")
    return got.numpy()


def test_bucket_engine_pads_ragged_bucket_with_row_zero(lm, served):
    """Three requests in a bucket of 4 dispatch as [p0, p1, p0, p0]: the
    per-tensor activation scale sees the padded batch, as in the
    reference's engine."""
    p0, p1 = served[0]
    eng = ServeEngine(LMRunner(lm["params"], lm["cfg"], new_tokens=4),
                      max_batch=4)
    res = eng.serve([p0, p1, p0])
    want = _port_serve(lm, [p0, p1, p0, p0], 4)
    np.testing.assert_array_equal(np.stack([r.value for r in res]), want[:3])
    assert eng.stats["padded_rows"] == 1


def test_bucket_engine_per_request_horizons(lm, served):
    prompts, ref = served
    eng = ServeEngine(LMRunner(lm["params"], lm["cfg"], new_tokens=6),
                      max_batch=4)
    res = eng.serve([(prompts[0], 3), prompts[1], (prompts[0], 6)])
    assert [len(r.value) for r in res] == [3, 6, 6]
    np.testing.assert_array_equal(res[0].value,
                                  _port_serve(lm, [prompts[0]], 3)[0])
    # the horizon-6 bucket holds the reference's batch, in another order
    np.testing.assert_array_equal(res[1].value, ref[1])
    np.testing.assert_array_equal(res[2].value, ref[0])
    assert eng.stats["dispatches"] == 2


def test_flash_serve_once_tokens_equal_reference(lm, monkeypatch):
    s = 16
    prompts = np.random.RandomState(4).randint(0, 64, (2, s)).astype(np.int32)
    key = jops.attn_plan_key(jops.AttnShape(
        seq_q=s, seq_kv=s, heads=3, head_dim=32, causal=True, window=None,
        quantized=True), "cpu")
    jops.install_plan_table({key: "flash"})
    try:
        ref, _ = jserve.serve_once(lm["jparams"], lm["jcfg"], jconfigs.SINGLE,
                                   jnp.asarray(prompts), 5, "serve")
    finally:
        jops.clear_plan_state()
    monkeypatch.setattr(targets, "ATTN_FLASH_SEQ_MIN", s)
    got, _ = serve.serve_once(lm["params"], lm["cfg"], configs.SINGLE,
                              _t(prompts), 5, "serve")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cpu_serving_launches_no_kernel(lm, served, monkeypatch):
    monkeypatch.setattr(targets, "ATTN_FLASH_SEQ_MIN", 8)
    _lib.reset_launches()
    serve.serve_once(lm["params"], lm["cfg"], configs.SINGLE,
                     _t(served[0]), 3, "serve")
    assert all(v == 0 for v in _lib.LAUNCHES.values())


def test_cli_runs_on_cpu(capsys):
    serve.main(["--device", "cpu", "--quant", "w1a8", "--batch", "2",
                "--prompt-len", "8", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=phi3-mini-3.8b-smoke quant=w1a8 device=cpu" in out
    assert "generated 2x3 tokens" in out


@pytest.mark.parametrize("flag", [["--plan-cache"], ["--autotune"],
                                  ["--quant", "w32a32"]])
def test_cli_unported_modes_raise(flag, tmp_path, capsys):
    """Every serve mode runs: the unquantized path (``--quant w32a32``)
    serves the float weights through the train-mode ``qdense``, as the
    reference does; LM plans (``--plan-cache``, ``--autotune``) serve the
    tokens of the plan-free run."""
    base = ["--device", "cpu", "--quant", "w1a8", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "3"]
    if flag == ["--quant", "w32a32"]:
        serve.main(base + flag)
        out = capsys.readouterr().out
        assert "quant=w32a32 device=cpu engine=train" in out
        assert "generated 2x3 tokens" in out
        return
    if flag == ["--plan-cache"]:
        flag = flag + [str(tmp_path / "lm")]
    serve.main(base)
    plain = capsys.readouterr().out
    serve.main(base + flag)
    out = capsys.readouterr().out
    assert "plan: compiled" in out
    samples = [ln for ln in plain.splitlines() if "sample[" in ln]
    assert samples and samples == [ln for ln in out.splitlines()
                                   if "sample[" in ln]


def test_cli_chaos_runs_on_cpu(capsys, tmp_path):
    serve.main(["--device", "cpu", "--quant", "w1a8", "--batch", "2",
                "--prompt-len", "8", "--new-tokens", "7", "--requests", "4",
                "--chaos-mtbf", "3", "--chaos-seed", "1", "--epoch-steps",
                "2", "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "completed 4/4" in out
    assert "bit-identical to fault-free: True" in out
    assert "resumes=" in out and "faults=0 " not in out


# ---------------------------------------------------------------------------
# params: layout and conversion
# ---------------------------------------------------------------------------

def test_init_lm_layout_equals_reference(lm):
    jshapes = jax.eval_shape(lambda k: JT.init_lm(k, lm["jcfg"],
                                                  jconfigs.SINGLE)[0],
                             jax.random.PRNGKey(0))
    got = T.init_lm(torch.Generator().manual_seed(0), lm["cfg"],
                    configs.SINGLE)
    flat_j = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    assert len(flat_j) == 11
    for path, leaf in flat_j:
        t = got
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == tuple(leaf.shape), path
        assert t.dtype == torch.float32
    std = float(got["blocks"]["attn"]["mlp"]["w_out"].std())
    assert abs(std * math.sqrt(GEOM["d_ff"]) - 1.0) < 0.1
    assert abs(float(got["embed"].std()) - 0.02) < 0.002


def test_lm_params_from_numpy_types_and_range(lm):
    wq = lm["params"]["blocks"]["attn"]["attn"]["wq"]
    assert wq["q"].dtype == torch.int8 and wq["q"].shape == (2, 64, 96)
    assert wq["s"].shape == (2,) and wq["s"].dtype == torch.float32
    assert lm["params"]["embed"].dtype == torch.float32
    bad = {"w": {"q": np.full((1, 8, 8), 2, np.int8), "s": np.ones(1),
                 "z": np.ones(1)}}
    with pytest.raises(ValueError):
        convert.lm_params_from_numpy(bad, lm["cfg"], device="cpu")
