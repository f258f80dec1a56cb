"""The port's MoE FFN, RG-LRU and RWKV-6 blocks, and the train-mode
(fake-quant) ``qdense`` they reach, held against the reference's
(``repro.models.layers``/``rglru``/``rwkv6``, ``repro.core.quant``) on the
same numpy-seeded inputs, each reference function jitted.

Tolerances:
* integers and routing exactly: the fake-quant activation levels, the MoE
  top-k experts and the set of (token, k) slots dropped for capacity;
* float outputs within 1e-5 x max|out| (float32): XLA and PyTorch sum
  matmuls, means and the 1-bit weight scale ``mean|w|`` in other orders,
  and their exp/tanh/sigmoid differ by ulps.

Where such an ulp moves a value across a rounding boundary of a
per-tensor-quantized activation, one activation level flips and the
block's output moves by that level's effect, far past 1e-5.  Those cases
(``FLIPS``) are pinned, not loosened: every ``qdense`` of the block is
equal when fed the reference's own inputs (recorded from an eager run of
the reference), the divergence exists (so the test fails once it is
closed), and it stays within one activation level of the output's scale,
``2^-(a_bits-1) x max|out|``.  ROADMAP Queue C records each one.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import rwkv6 as JW  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import rglru as R  # noqa: E402
from repro_torch.models import rwkv6 as W  # noqa: E402

TOL = 1e-5   # x max|out|
QUANTS = ["w1a8", "w1a4", "w2a2"]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= tol * float(np.abs(ref).max())


def _cfgs(arch, qname="w1a8", **over):
    jcfg = dataclasses.replace(jconfigs.get_config(arch).smoke(**over),
                               quant=jquant.PAPER_CONFIGS[qname])
    cfg = dataclasses.replace(configs.get_config(arch).smoke(**over),
                              quant=quant.PAPER_CONFIGS[qname])
    return jcfg, cfg


def _w(rs, *shape, scale=None):
    s = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    return (rs.randn(*shape) * s).astype(np.float32)


def reference_qdense_calls(monkeypatch, fn) -> list:
    """Run the reference's ``fn()`` eagerly with every ``qdense`` of its
    model modules recording its inputs: ``[(x, w, quant, role, mode)]``
    as numpy.  (Eager values differ from jitted ones by ulps; the calls
    only supply inputs that both sides' ``qdense`` then take.)"""
    calls = []
    orig = JL.qdense

    def rec(x, w, q, *, role="mid", mode="train"):
        calls.append((np.asarray(x), jax.tree.map(np.asarray, w), q, role,
                      mode))
        return orig(x, w, q, role=role, mode=mode)

    with monkeypatch.context() as mp:
        for mod in (JL, JR, JW, JT):
            mp.setattr(mod, "qdense", rec)
        fn()
    return calls


def assert_qdense_equal_on_reference_inputs(calls) -> None:
    """Each recorded call through the port's ``qdense`` and the jitted
    reference's on the same inputs: a prequantized weight's signed level
    GEMM bit for bit; a float weight's fake-quant product with the same
    activation levels, within tolerance; an fp matmul within tolerance."""
    assert calls
    for x, w, q, role, mode in calls:
        tq = quant.QuantConfig(**dataclasses.asdict(q))
        ref = np.asarray(jax.jit(lambda a, b, q=q, role=role, mode=mode:
                                 JL.qdense(a, b, q, role=role, mode=mode))(
            x, w))
        if isinstance(w, dict):
            tw = convert.lm_params_from_numpy({"w": w}, tq, device="cpu")["w"]
            got = L.qdense(_t(x), tw, tq, role=role, mode=mode)
            np.testing.assert_array_equal(got.numpy(), ref)
            continue
        got = L.qdense(_t(x), _t(w), tq, role=role, mode=mode)
        _close(got, ref)
        if not (q.engine == "fp" or q.w_bits >= 32 or (
                role in ("first", "last") and q.first_last_fp)):
            np.testing.assert_array_equal(
                quant.fake_quant_act_signed(_t(x), q.a_bits).numpy(),
                np.asarray(jax.jit(lambda a, b=q.a_bits:
                                   jquant.fake_quant_act_signed(a, b))(x)))


# a pinned flip's bound at a model's logits: one flipped level's effect
# after the layers that follow it (measured 0.12-3.4%; ROADMAP Queue C)
FLIP_BOUND = 0.04  # x max|logit|


def assert_pinned_logits(got: np.ndarray, ref: np.ndarray,
                         argmax_flips: int = 0) -> None:
    """Real-vocab logits of a pinned flip: they diverge past the 1e-5
    tolerance (the test fails once the divergence is closed), by at most
    ``FLIP_BOUND`` x max|logit|, and the argmax is equal at every position
    but exactly ``argmax_flips`` pinned ones, each where the reference's
    top-2 margin is under twice the divergence (a near-tie the flip can
    reorder)."""
    scale = float(np.abs(ref).max())
    diff = float(np.abs(got - ref).max())
    assert TOL * scale < diff <= FLIP_BOUND * scale, diff / scale
    moved = got.argmax(-1) != ref.argmax(-1)
    assert int(moved.sum()) == argmax_flips
    top2 = np.sort(ref, axis=-1)[..., -2:]
    assert np.all((top2[..., 1] - top2[..., 0])[moved] < 2 * diff)


def assert_pinned_flip(got, ref, a_bits: int) -> float:
    """A pinned level flip: the output diverges past the 1e-5 tolerance
    (fails once the divergence is closed) and by at most one activation
    level of its scale, ``2^-(a_bits-1) x max|out|``.  Returns the
    relative divergence."""
    ref = np.asarray(ref, np.float32)
    rel = (float(np.abs(got.detach().float().numpy() - ref).max())
           / float(np.abs(ref).max()))
    assert TOL < rel <= 2.0 ** -(a_bits - 1), rel
    return rel


# ---------------------------------------------------------------------------
# fake-quant quantizers and the train-mode qdense
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4, 2])
def test_fake_quant_act_signed_equals_reference(bits):
    """The STE forward value ``a + (q - a)``, level for level."""
    a = np.random.RandomState(bits).randn(3, 17, 64).astype(np.float32) * 1.7
    ref = jax.jit(lambda x: jquant.fake_quant_act_signed(x, bits))(a)
    got = quant.fake_quant_act_signed(_t(a), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_quantize_weight_equals_reference(bits):
    """DoReFa weights, level for level: 1-bit within 4e-7 relative, a few
    ulps (XLA's float32 sum for ``mean|w|`` and the port's float64 one
    differ by up to an ulp, and ``w + (q - w)`` rounds twice),
    k-bit within 1e-6 (XLA's tanh differs from PyTorch's by ulps in most
    elements; a level apart would be 2/(2^k - 1))."""
    w = np.random.RandomState(bits).randn(96, 40).astype(np.float32) * 0.3
    ref = np.asarray(jax.jit(lambda x: jquant.quantize_weight(x, bits))(w))
    got = quant.quantize_weight(_t(w), bits).numpy()
    if bits == 1:
        assert np.array_equal(np.sign(got), np.sign(ref))
        np.testing.assert_allclose(got, ref, rtol=4e-7, atol=0)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("qname", QUANTS)
def test_qdense_train_mode_equals_reference(qname):
    q = jquant.PAPER_CONFIGS[qname]
    rs = np.random.RandomState(7)
    x, w = rs.randn(2, 9, 64).astype(np.float32), _w(rs, 64, 48)
    ref = jax.jit(lambda a, b: JL.qdense(a, b, q))(x, w)
    got = L.qdense(_t(x), _t(w), quant.PAPER_CONFIGS[qname])
    _close(got, ref)
    # mode="train" is the default, a float weight's path on a quantized
    # config; the serve mode takes prequantized weights only
    with pytest.raises(ValueError, match="prequantized"):
        L.qdense(_t(x), _t(w), quant.PAPER_CONFIGS[qname], mode="serve")
    # fp configs and fp first/last layers are a plain matmul
    np.testing.assert_array_equal(
        L.qdense(_t(x), _t(w), quant.FP32).numpy(), (_t(x) @ _t(w)).numpy())
    np.testing.assert_array_equal(
        L.qdense(_t(x), _t(w), quant.PAPER_CONFIGS[qname],
                 role="last").numpy(), (_t(x) @ _t(w)).numpy())


@pytest.mark.parametrize("fn,jfn", [
    (L.gelu_tanh, jax.nn.gelu), (L.silu, jax.nn.silu),
    (L.softplus, jax.nn.softplus)])
def test_activations_equal_reference(fn, jfn):
    x = np.random.RandomState(3).randn(4096).astype(np.float32) * 4
    x[:4] = (-30.0, 30.0, 0.0, -1e-3)
    ref = np.asarray(jax.jit(jfn)(x))
    got = fn(_t(x)).numpy()
    # XLA's exp and tanh are its own approximations: a few ulps apart
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_params(rs, cfg):
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    p = {"ln": (1 + 0.1 * rs.randn(d)).astype(np.float32),
         "router": _w(rs, d, E), "w1": _w(rs, E, d, ff),
         "wg": _w(rs, E, d, ff), "w2": _w(rs, E, ff, d)}
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        p["shared"] = {"ln": np.ones(d, np.float32), "w_in": _w(rs, d, sff),
                       "w_gate": _w(rs, d, sff), "w_out": _w(rs, sff, d)}
    return p


def _tree(p):
    return {k: (_tree(v) if isinstance(v, dict) else _t(v))
            for k, v in p.items()}


def _ref_route(p, x, jcfg):
    """The reference's routing, op for op (``moe_fwd``'s first lines):
    top-k experts and the slots kept within capacity."""
    T = x.shape[0] * x.shape[1]
    h = JL.rms_norm(jnp.asarray(x).reshape(T, -1), p["ln"])
    probs = jax.nn.softmax((h @ p["router"]).astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, jcfg.top_k)
    C = min(T, max(int(math.ceil(jcfg.capacity_factor * T * jcfg.top_k
                                 / jcfg.n_experts)), 4))
    e_flat = idx.reshape(-1)
    onehot = jax.nn.one_hot(e_flat, jcfg.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    return idx, pos < C, C


@pytest.mark.parametrize("arch,cf", [
    ("deepseek-moe-16b", 1.25), ("granite-moe-3b-a800m", 1.25),
    ("deepseek-moe-16b", 0.5), ("granite-moe-3b-a800m", 0.5)])
def test_moe_fwd_equals_reference(arch, cf):
    """Routing (top-k ties to the lower index), the capacity drops and the
    combine: the same experts, the same dropped (token, k) slots, and the
    output within tolerance; ``cf=0.5`` forces drops.  deepseek has a
    shared expert (a train-mode MLP), granite none."""
    jcfg, cfg = _cfgs(arch, capacity_factor=cf)
    rs = np.random.RandomState(11)
    p = _moe_params(rs, cfg)
    x = rs.randn(2, 12, cfg.d_model).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    ref, ref_aux = jax.jit(lambda pp, xx: JL.moe_fwd(pp, xx, jcfg))(jp, x)
    tp = _tree(p)
    got, aux = L.moe_fwd(tp, _t(x), cfg)
    _close(got, ref)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-6)
    idx, keep, cap = _ref_route(jp, x, jcfg)
    r = L.moe_route(tp, L.rms_norm(_t(x).reshape(24, -1), tp["ln"]), cfg)
    assert r["capacity"] == cap
    np.testing.assert_array_equal(r["idx"].numpy(), np.asarray(idx))
    np.testing.assert_array_equal(r["keep"].numpy(), np.asarray(keep))
    if cf < 1:
        assert int((~r["keep"]).sum()) > 0


def test_moe_top_k_breaks_ties_toward_the_lower_index():
    """Equal router probabilities: ``lax.top_k`` keeps the lower expert
    index first, and so does the port."""
    jcfg, cfg = _cfgs("granite-moe-3b-a800m")
    d = cfg.d_model
    p = {"ln": np.ones(d, np.float32),
         "router": np.zeros((d, cfg.n_experts), np.float32)}
    h = np.random.RandomState(0).randn(6, d).astype(np.float32)
    r = L.moe_route(_tree(p), _t(h), cfg)
    _, idx = jax.lax.top_k(jax.nn.softmax(jnp.zeros((6, cfg.n_experts))),
                           cfg.top_k)
    np.testing.assert_array_equal(r["idx"].numpy(), np.asarray(idx))
    assert r["idx"][0].tolist() == [0, 1]


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rec_params(rs, cfg):
    d, Wd, cw = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.conv_width
    u = rs.uniform(0.9, 0.999, Wd)
    return {"ln": (1 + 0.1 * rs.randn(d)).astype(np.float32),
            "wx": _w(rs, d, Wd), "wy": _w(rs, d, Wd),
            "conv_w": _w(rs, cw, Wd), "conv_b": _w(rs, 1, Wd, scale=0.1)[0],
            "wr": _w(rs, Wd, Wd), "wi": _w(rs, Wd, Wd),
            "lam": np.log(np.exp(-np.log(u) / 8.0) - 1.0).astype(np.float32),
            "wo": _w(rs, Wd, d)}


@pytest.mark.parametrize("with_state", [False, True])
def test_rec_block_fwd_equals_reference(with_state):
    jcfg, cfg = _cfgs("recurrentgemma-9b")
    rs = np.random.RandomState(12)
    p = _rec_params(rs, cfg)
    x = rs.randn(2, 10, cfg.d_model).astype(np.float32)
    state = None
    if with_state:
        state = {"h": rs.randn(2, 128).astype(np.float32),
                 "conv": rs.randn(2, cfg.conv_width - 1, 128).astype(
                     np.float32)}
    jp = jax.tree.map(jnp.asarray, p)
    ref, rst = jax.jit(lambda pp, xx, st: JR.rec_block_fwd(
        pp, xx, jcfg, jconfigs.SINGLE, mode="prefill", state=st))(
        jp, x, state)
    got, st = R.rec_block_fwd(_tree(p), _t(x), cfg, configs.SINGLE,
                              mode="prefill",
                              state=_tree(state) if state else None)
    _close(got, ref)
    _close(st["h"], rst["h"])
    _close(st["conv"], rst["conv"])
    assert st["h"].dtype == st["conv"].dtype == torch.float32


def test_rglru_pieces_equal_reference():
    """The causal conv (taps summed in order; XLA contracts some of its
    multiply-adds, so within tolerance) and the sequential scan."""
    rs = np.random.RandomState(13)
    x = rs.randn(2, 9, 16).astype(np.float32)
    w, b = rs.randn(4, 16).astype(np.float32), rs.randn(16).astype(np.float32)
    carry = rs.randn(2, 3, 16).astype(np.float32)
    ref, rc = jax.jit(JR._causal_conv1d)(x, w, b, carry)
    got, c = R._causal_conv1d(_t(x), _t(w), _t(b), _t(carry))
    _close(got, ref)
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    a = rs.uniform(0.5, 0.999, (2, 9, 16)).astype(np.float32)
    h0 = rs.randn(2, 16).astype(np.float32)
    rh, rl = jax.jit(JR._rglru_scan)(x, a, h0)
    gh, gl = R._rglru_scan(_t(x), _t(a), _t(h0))
    _close(gh, rh)
    _close(gl, rl)


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

def _rwkv_params(rs, cfg):
    d, hd, r, ff = cfg.d_model, cfg.rwkv_head_dim, cfg.lora_rank, cfg.d_ff
    H = d // hd
    u = lambda *s: rs.uniform(0, 1, s).astype(np.float32)  # noqa: E731
    p = {"ln1": np.ones(d, np.float32), "ln2": np.ones(d, np.float32),
         "mu_base": u(d), "mus": u(5, d),
         "lora_A": _w(rs, d, 5, r, scale=0.1),
         "lora_B": _w(rs, 5, r, d, scale=0.1),
         "lam": (-2 + 0.3 * rs.randn(d)).astype(np.float32),
         "u": _w(rs, H, hd, scale=0.3), "ln_x": u(H, hd) + 0.5,
         "cm_mu_k": u(d), "cm_mu_r": u(d),
         "cm_wk": _w(rs, d, ff), "cm_wv": _w(rs, ff, d),
         "cm_wr": _w(rs, d, d)}
    for nm in ("wr", "wk", "wv", "wg", "wo"):
        p[nm] = _w(rs, d, d)
    return p


# the module cases where one activation level flips (ROADMAP Queue C)
FLIPS = {("rwkv", "with_state")}


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_block_fwd_equals_reference(with_state, monkeypatch):
    """Time mix and channel mix, from zero state and from a carried one.
    From the carried state, one level of the per-tensor-quantized
    ``cm_wv`` input (``relu(.)^2``, whose square doubles each ulp) flips
    between XLA and PyTorch: pinned (``FLIPS``)."""
    jcfg, cfg = _cfgs("rwkv6-1.6b")
    rs = np.random.RandomState(14)
    p = _rwkv_params(rs, cfg)
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    x = rs.randn(2, 10, d).astype(np.float32)
    state = None
    if with_state:
        state = {"tm_x": rs.randn(2, d).astype(np.float32),
                 "cm_x": rs.randn(2, d).astype(np.float32),
                 "s": rs.randn(2, d // hd, hd, hd).astype(np.float32) * 0.1}
    jp = jax.tree.map(jnp.asarray, p)
    ref, rst = jax.jit(lambda pp, xx, st: JW.rwkv_block_fwd(
        pp, xx, jcfg, jconfigs.SINGLE, mode="prefill", state=st))(
        jp, x, state)
    got, st = W.rwkv_block_fwd(_tree(p), _t(x), cfg, configs.SINGLE,
                               mode="prefill",
                               state=_tree(state) if state else None)
    # the time-mix state is computed before the channel mix
    _close(st["tm_x"], rst["tm_x"])
    _close(st["s"], rst["s"])
    assert st["s"].dtype == torch.float32
    if ("rwkv", "with_state" if with_state else "zero") in FLIPS:
        assert_qdense_equal_on_reference_inputs(reference_qdense_calls(
            monkeypatch, lambda: JW.rwkv_block_fwd(
                jp, jnp.asarray(x), jcfg, jconfigs.SINGLE, mode="prefill",
                state=jax.tree.map(jnp.asarray, state))))
        assert_pinned_flip(got, ref, cfg.quant.a_bits)
        return
    _close(got, ref)
    _close(st["cm_x"], rst["cm_x"])


def test_wkv_scan_equals_reference():
    rs = np.random.RandomState(15)
    r, k, w = (rs.randn(2, 7, 2, 8).astype(np.float32) for _ in range(3))
    w = 1 / (1 + np.exp(-w))
    v = rs.randn(2, 7, 2, 8).astype(np.float32)
    u = rs.randn(2, 8).astype(np.float32)
    s0 = rs.randn(2, 2, 8, 8).astype(np.float32)
    ro, rs_ = jax.jit(JW._wkv_scan)(r, k, v, w, u, s0)
    go, gs = W._wkv_scan(*(_t(a) for a in (r, k, v, w, u, s0)))
    _close(go, ro)
    _close(gs, rs_)
