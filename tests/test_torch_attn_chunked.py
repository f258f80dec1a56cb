"""The port's plain-PyTorch attention engines ``attn_chunked`` (online
softmax over padded KV chunks) and ``attn_banded`` (block-diagonal window
bands), and the ``attention_fwd`` branches that reach them, held against
the reference's (``repro.models.layers``) on the same numpy-seeded inputs.

Tolerances (``max|v|`` the largest value magnitude):
* float32 inputs: within 1e-5 x max|v| (exp and the summation order differ
  by ulps between XLA and PyTorch);
* bfloat16 inputs: within one bfloat16 rounding, 2^-7 x max|v| (both round
  the softmax weights to bfloat16 before P @ V and the output once).

Lengths include primes that no chunk divides (the reference's S=1021
case, scaled down to 61), causal and non-causal, windowed and not; the
chunk plan equals the reference's over a range of lengths.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.api import targets  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7
DTYPES = {"float32": (torch.float32, jnp.float32, F32_TOL),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}


def _qkv(s_q, s_kv, h=3, hd=16, b=2, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, h, hd).astype(np.float32)
            for s in (s_q, s_kv, s_kv)]


def _both(arrs, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a, jdt) for a in arrs])


def _close(got, ref, v, tol):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    bound = tol * float(np.abs(v).max())
    assert float(np.abs(got - ref).max()) <= bound


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,chunk", [(61, 16), (61, 61), (64, 16), (7, 4),
                                     (61, 1024)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 8), (False, 13)])
def test_attn_chunked_equals_reference(dtype, s, chunk, causal, window):
    arrs = _qkv(s, s)
    (q, k, v), (jq, jk, jv) = _both(arrs, dtype)
    pos = np.arange(s, dtype=np.int32)
    got = L.attn_chunked(q, k, v, causal=causal, window=window,
                         q_pos=torch.from_numpy(pos),
                         kv_pos=torch.from_numpy(pos), q_chunk=chunk,
                         kv_chunk=chunk)
    ref = JL.attn_chunked(jq, jk, jv, causal=causal, window=window,
                          q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
                          q_chunk=chunk, kv_chunk=chunk)
    assert got.shape == tuple(ref.shape) and got.dtype == q.dtype
    _close(got, ref, arrs[2], DTYPES[dtype][2])


@pytest.mark.parametrize("skip", [True, False])
def test_attn_chunked_skipping_masked_chunks_changes_nothing(skip):
    """A skipped chunk leaves the running state exactly as computing it
    would: the output with skipping equals the output without, bit for
    bit, and both equal the reference's."""
    arrs = _qkv(61, 61)
    (q, k, v), (jq, jk, jv) = _both(arrs, "float32")
    pos = torch.arange(61, dtype=torch.int32)
    kw = dict(causal=True, window=8, q_pos=pos, kv_pos=pos, q_chunk=16,
              kv_chunk=16)
    got = L.attn_chunked(q, k, v, skip_masked=skip, **kw)
    assert torch.equal(got, L.attn_chunked(q, k, v, skip_masked=not skip,
                                           **kw))
    ref = JL.attn_chunked(jq, jk, jv, causal=True, window=8,
                          q_pos=jnp.arange(61), kv_pos=jnp.arange(61),
                          q_chunk=16, kv_chunk=16, skip_masked=skip)
    _close(got, ref, arrs[2], F32_TOL)


def test_attn_chunked_masks_invalid_cache_slots():
    """A decode-shaped call over a cache with empty (-1) slots: the empty
    slots get no weight, as in the reference."""
    arrs = _qkv(1, 40)
    (q, k, v), (jq, jk, jv) = _both(arrs, "float32")
    kv_pos = np.where(np.arange(40) < 29, np.arange(40), -1).astype(np.int32)
    q_pos = np.asarray([28], np.int32)
    got = L.attn_chunked(q, k, v, causal=True, window=None,
                         q_pos=torch.from_numpy(q_pos),
                         kv_pos=torch.from_numpy(kv_pos), kv_chunk=16)
    ref = JL.attn_chunked(jq, jk, jv, causal=True, window=None,
                          q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
                          kv_chunk=16)
    _close(got, ref, arrs[2], F32_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,window", [(61, 8), (64, 16), (17, 8), (40, 13)])
def test_attn_banded_equals_reference(dtype, s, window):
    arrs = _qkv(s, s)
    (q, k, v), (jq, jk, jv) = _both(arrs, dtype)
    pos = np.arange(s, dtype=np.int32)
    got = L.attn_banded(q, k, v, window=window, q_pos=torch.from_numpy(pos),
                        kv_pos=torch.from_numpy(pos))
    ref = JL.attn_banded(jq, jk, jv, window=window, q_pos=jnp.asarray(pos),
                         kv_pos=jnp.asarray(pos))
    assert got.shape == tuple(ref.shape)
    _close(got, ref, arrs[2], DTYPES[dtype][2])
    # and the band equals the full masked attention it stands for
    full = L.attn_full(q, k, v, causal=True, window=window,
                       q_pos=torch.from_numpy(pos),
                       kv_pos=torch.from_numpy(pos))
    _close(got, full.float().numpy(), arrs[2], DTYPES[dtype][2])


@pytest.mark.parametrize("target", [1, 7, 16, 64, 1024])
def test_chunk_plan_equals_reference(target):
    for n in range(1, 300):
        assert L._chunk_plan(n, target) == JL._chunk_plan(n, target)


def test_pad_helpers_equal_reference():
    x = np.random.RandomState(0).randn(2, 5, 3).astype(np.float32)
    got = L._pad_chunk_dim(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JL._pad_chunk_dim(x, 8)))
    pos = np.arange(5, dtype=np.int32)
    np.testing.assert_array_equal(
        L._pad_positions(torch.from_numpy(pos), 8).numpy(),
        np.asarray(JL._pad_positions(jnp.asarray(pos), 8)))
    # no padding needed: the input itself
    t = torch.from_numpy(x)
    assert L._pad_chunk_dim(t, 5) is t


# ---------------------------------------------------------------------------
# attention_fwd's engine branches through the model, vs the reference's
# ---------------------------------------------------------------------------

GEOM = dict(n_layers=2, d_model=64, n_heads=3, n_kv_heads=1, d_ff=128,
            vocab=64, head_dim=32)


def numpy_lm_params(geom, seed: int = 0) -> dict:
    """Float LM params in the reference's layout, drawn with numpy."""
    rs = np.random.RandomState(seed)
    n, d, hd = geom["n_layers"], geom["d_model"], geom["head_dim"]
    h, hk, ff = geom["n_heads"], geom["n_kv_heads"], geom["d_ff"]

    def w(*shape):
        return (rs.randn(*shape) / np.sqrt(shape[-2])).astype(np.float32)

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
    jp = JL.prequantize_params(jax.tree.map(jnp.asarray,
                                            numpy_lm_params(GEOM)), jcfg)
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                          device="cpu")
    return dict(cfg=cfg, params=params, jcfg=jcfg, jparams=jp)


@pytest.mark.parametrize("engine", ["chunked", "full"])
def test_prefill_on_the_chunked_engine_equals_reference(lm, engine,
                                                        monkeypatch):
    """The whole prefill with the chunked engine chosen by the dispatcher
    (the port through its threshold, the reference through its plan
    table) gives the reference's logits within 1e-5 x max|logit|, and the
    full engine's within the same bound."""
    s = 12
    toks = np.random.RandomState(1).randint(0, 64, (2, s)).astype(np.int32)
    if engine == "chunked":
        monkeypatch.setattr(targets, "ATTN_CHUNK_SEQ_MIN", s)
    assert ops.select_attn_engine(ops.AttnShape(
        seq_q=s, seq_kv=s, heads=3, head_dim=32, quantized=True)) == engine
    jops.install_plan_table({jops.attn_plan_key(jops.AttnShape(
        seq_q=s, seq_kv=s, heads=3, head_dim=32, quantized=True), "cpu"):
        engine})
    try:
        ref, _ = jax.jit(lambda p, t: JT.prefill(
            p, lm["jcfg"], jconfigs.SINGLE, tokens=t, qmode="serve"))(
            lm["jparams"], jnp.asarray(toks))
    finally:
        jops.clear_plan_state()
    got, _ = T.prefill(lm["params"], lm["cfg"], configs.SINGLE,
                       tokens=torch.from_numpy(toks), qmode="serve")
    ref = np.asarray(ref)
    tol = 1e-5 * float(np.abs(ref).max())
    assert float(np.abs(got.numpy() - ref).max()) <= tol


def test_engine_branches_on_explicit_engines(lm):
    """``attention_fwd`` with each engine pinned: chunked and banded give
    the full engine's output within 1e-5 x max|out| (banded on a window
    shorter than half the sequence), and an unknown engine raises."""
    cfg = lm["cfg"]
    layer = T.unstack_layers(lm["params"], cfg)[0]["attn"]
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 40, 64).astype(
        np.float32))
    outs = {}
    for eng, window in (("full", 8), ("chunked", 8), ("banded", 8),
                        ("full", None), ("chunked", None)):
        outs[eng, window], _ = L.attention_fwd(
            layer, x, cfg, configs.SINGLE, mode="prefill", window=window,
            engine=eng)
    for (eng, window), out in outs.items():
        ref = outs["full", window]
        tol = 1e-5 * float(ref.abs().max())
        assert float((out - ref).abs().max()) <= tol, (eng, window)
    with pytest.raises(ValueError, match="unknown attention engine"):
        L.attention_fwd(layer, x, cfg, configs.SINGLE, mode="prefill",
                        engine="sparse")
