"""The port's dispatch state and measured autotune
(``repro_torch.kernels.ops``: plan table, autotune cache, dispatch epoch,
``select_engine`` / ``select_attn_engine``, ``candidate_engines``,
``autotune_engine``; ``core.plan``: ``compile_model(autotune=True)``,
``ModelPlan.install`` / ``activate``, ``load_plan``'s restore) held to the
reference's (``repro.kernels.ops``, ``repro.core.plan``), and the signed
LM engines held to each other and to the reference bit for bit.

* resolution order: the plan table (dense only), then the autotune cache,
  then the cost model — the same answers as the reference under the same
  installed tables, and ``dispatch_epoch`` moves where the reference's
  does;
* the candidates on the ``cuda`` target are the reference's ``tpu`` list
  for dense problems, in its order;
* CPU autotune on svhn(8) at 16x16: every verdict is one of its
  candidates, the measurements persist in the plan, a reload measures
  nothing (``_time_engine`` patched to raise) and the logits equal the
  heuristic plan's bit for bit; a CPU verdict is never read for the card;
* every signed engine (``planes``, ``packed``, ``int8``, ``f32dot``)
  gives the same LM dense output bit for bit, equal to the reference's.

Everything runs here on the CPU (the kernels' plain versions).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import and_accum as jaa  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import and_accum as aa  # noqa: E402
from repro_torch.core import plan as P  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

IMG = 16
SPEC = cnn.svhn_cnn_spec(8)


@pytest.fixture(autouse=True)
def _clean_state():
    ops.clear_plan_state()
    jops.clear_plan_state()
    yield
    ops.clear_plan_state()
    jops.clear_plan_state()


def _params(seed=0):
    return cnn.init_cnn(torch.Generator().manual_seed(seed), SPEC)


def _images(n=4, seed=1):
    return torch.from_numpy(np.random.RandomState(seed).uniform(
        0, 1, (n, IMG, IMG, 3)).astype(np.float32))


# ---------------------------------------------------------------------------
# resolution order and the dispatch epoch, against the reference
# ---------------------------------------------------------------------------

DENSE = (64, 512, 256, 8, 1)        # m, k, n, a_bits, w_bits


def test_select_engine_resolution_order_equals_reference():
    m, k, n, a, w = DENSE
    conv = ops.ConvShape(8, 8, 3, 3, 1, "SAME", batch=1)
    jconv = jops.ConvShape(8, 8, 3, 3, 1, "SAME", batch=1)
    # (3) no table, no measurement: the cost model
    assert ops.select_engine(m, k, n, a, w) == ops.cost_model_engine(
        m, k, n, a, w) == "fused"
    assert jops.select_engine(m, k, n, a, w, "tpu") == "fused"
    # (2) a measurement beats the cost model
    ops._AUTOTUNE_CACHE[ops.autotune_key(m, k, n, a, w, "cuda", None)] = (
        "int8", {})
    jops._AUTOTUNE_CACHE[jops.autotune_key(m, k, n, a, w, "tpu", None)] = (
        "int8", {})
    assert ops.select_engine(m, k, n, a, w) == jops.select_engine(
        m, k, n, a, w, "tpu") == "int8"
    # (1) the plan table beats both, for dense problems only
    ops.install_plan_table({ops.dense_plan_key(k, n, a, w, "cuda"): "f32dot"})
    jops.install_plan_table({jops.dense_plan_key(k, n, a, w, "tpu"):
                             "f32dot"})
    assert ops.select_engine(m, k, n, a, w) == jops.select_engine(
        m, k, n, a, w, "tpu") == "f32dot"
    # a conv problem never reads the dense table
    ck = 3 * 3 * 8
    ops.install_plan_table({ops.dense_plan_key(ck, 16, a, w, "cuda"): "int8"})
    jops.install_plan_table({jops.dense_plan_key(ck, 16, a, w, "tpu"):
                             "int8"})
    assert ops.select_engine(conv.m, ck, 16, a, w, conv=conv) == \
        ops.cost_model_engine(conv.m, ck, 16, a, w, conv=conv)
    assert jops.select_engine(jconv.m, ck, 16, a, w, "tpu", jconv) == \
        jops.cost_model_engine(jconv.m, ck, 16, a, w, "tpu", jconv)
    # clear: back to the cost model
    ops.clear_plan_state()
    jops.clear_plan_state()
    assert ops.select_engine(m, k, n, a, w) == "fused"


def test_a_cpu_measurement_is_never_read_on_the_card():
    m, k, n, a, w = DENSE
    ops._AUTOTUNE_CACHE[ops.autotune_key(m, k, n, a, w, "cpu", None)] = (
        "int8", {})
    assert ops.select_engine(m, k, n, a, w, device="cpu") == "int8"
    assert ops.select_engine(m, k, n, a, w, device="cuda") == "fused"
    assert ops.select_engine(m, k, n, a, w) == "fused"


def test_select_attn_engine_consults_the_plan_table_first():
    shape = dict(seq_q=64, seq_kv=64, heads=3, head_dim=32, quantized=True)
    attn, jattn = ops.AttnShape(**shape), jops.AttnShape(**shape)
    assert ops.attn_plan_key(attn, "cuda")[:7] == jops.attn_plan_key(
        jattn, "tpu")[:7]
    assert ops.select_attn_engine(attn) == "full"
    ops.install_plan_table({ops.attn_plan_key(attn, "cuda"): "chunked"})
    jops.install_plan_table({jops.attn_plan_key(jattn, "tpu"): "chunked"})
    assert ops.select_attn_engine(attn) == jops.select_attn_engine(
        jattn, "tpu") == "chunked"
    # paged keys carry the page geometry: a 10-tuple
    paged = dict(shape, seq_q=1, seq_kv=256, page_size=16)
    key = ops.attn_plan_key(ops.AttnShape(**paged), "cuda")
    assert len(key) == 10 and key[8:] == (16, 256)
    assert key[:7] + key[8:] == (jops.attn_plan_key(
        jops.AttnShape(**paged), "tpu")[:7] + (16, 256))


def _epoch_trace(mod, backend, load=None):
    """Epoch deltas of the same operations on ops module ``mod``."""
    m, k, n, a, w = DENSE
    trace, last = [], mod.dispatch_epoch()

    def mark():
        nonlocal last
        now = mod.dispatch_epoch()
        trace.append(now - last)
        last = now

    key = mod.dense_plan_key(k, n, a, w, backend)
    mod.install_plan_table({key: "int8"})
    mark()
    mod.select_engine(m, k, n, a, w, backend)        # lookups never bump
    mark()
    mod.remove_plan_table({key: None})
    mark()
    mod.clear_plan_state()
    mark()
    if load is not None:
        load()
        mark()
    return trace


def test_dispatch_epoch_moves_where_the_reference_does(tmp_path):
    port_plan = P.compile_model(_params(), SPEC, quant.W1A4, target="cuda",
                                batch_hints=(1,), img_hw=IMG)
    port_plan = dataclasses.replace(port_plan, autotune={
        ("dense", 1, 2, 3, 4, 1, "cpu"): ("int8", {"int8": 1.0})})
    path = P.save_plan(port_plan, str(tmp_path / "p"))
    got = _epoch_trace(ops, "cuda", lambda: P.load_plan(path, device="cpu"))
    want = _epoch_trace(jops, "tpu", lambda: jplan.load_plan(path))
    assert got == want and got[1] == 0 and all(d > 0 for i, d in
                                               enumerate(got) if i != 1)
    # an autotune verdict bumps once, a cache hit does not
    e0 = ops.dispatch_epoch()
    ops.autotune_engine(*DENSE, device="cpu")
    e1 = ops.dispatch_epoch()
    ops.autotune_engine(*DENSE, device="cpu")
    assert e1 - e0 == 1 and ops.dispatch_epoch() == e1


def test_activate_restores_the_prior_table():
    plan = dataclasses.replace(
        P.compile_model(None, SPEC, quant.W1A4, img_hw=IMG),
        dense_table={("dense", 8, 8, 4, 1, "cuda"): "int8",
                     ("dense", 16, 8, 4, 1, "cuda"): "f32dot"})
    outer = {("dense", 8, 8, 4, 1, "cuda"): "fused"}
    ops.install_plan_table(outer)
    with plan.activate():
        assert ops._PLAN_TABLE[("dense", 8, 8, 4, 1, "cuda")] == "int8"
        assert ops._PLAN_TABLE[("dense", 16, 8, 4, 1, "cuda")] == "f32dot"
    assert ops._PLAN_TABLE == outer
    plan.install()
    assert ops._PLAN_TABLE == plan.dense_table


# ---------------------------------------------------------------------------
# candidates and measurement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 512, 256, 8, 1), (8, 4096, 10, 1, 1),
                                   (16, 96, 32, 4, 4), (4, 70000, 8, 8, 1),
                                   (4, 1 << 15, 8, 1, 1)])
def test_dense_candidates_equal_the_reference_tpu_list(shape):
    assert ops.candidate_engines(*shape) == jops.candidate_engines(
        *shape, "tpu")


def test_conv_candidates_lead_with_implicit_where_it_fits():
    conv = ops.ConvShape(16, 16, 3, 3, 1, "SAME", batch=8)
    c = ops.candidate_engines(conv.m, 3 * 3 * 64, 64, 1, 1, conv=conv)
    assert c == ["implicit", "fused", "faithful", "f32dot", "int8"]
    assert ops.candidate_engines(conv.m, 3 * 3 * 64, 64, 4, 1,
                                 conv=conv) == ["implicit", "fused",
                                                "f32dot", "int8"]
    assert ops.candidate_engines(8, 512, 64, 8, 1, signed=True) == [
        "f32dot", "int8"]


def test_autotune_engine_times_each_candidate_on_the_cpu(monkeypatch):
    calls = []
    real = ops._time_engine

    def spy(fn, *args, **kw):
        calls.append(kw.get("device"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(ops, "_time_engine", spy)
    conv = ops.ConvShape(8, 8, 3, 3, 1, "SAME", batch=2)
    best, times = ops.autotune_engine(conv.m, 72, 16, 4, 1, conv=conv,
                                      device="cpu")
    assert set(times) == set(ops.candidate_engines(conv.m, 72, 16, 4, 1,
                                                   conv=conv))
    assert best == min(times, key=times.get) and len(calls) == len(times)
    assert all(torch.device(d).type == "cpu" for d in calls)
    key = ops.autotune_key(conv.m, 72, 16, 4, 1, "cpu", conv)
    assert ops._AUTOTUNE_CACHE[key] == (best, times)
    # cached: no second measurement
    assert ops.autotune_engine(conv.m, 72, 16, 4, 1, conv=conv,
                               device="cpu") == (best, times)
    assert len(calls) == len(times)


def test_cnn_autotune_on_the_cpu(tmp_path, monkeypatch):
    """svhn(8) at 16x16, W1A1 and W1A4: verdicts among the candidates,
    measurements persisted, logits equal to the heuristic plan's, and a
    reload (with a cleared cache) that measures nothing."""
    params, x = _params(), _images()
    for q in (quant.W1A1, quant.W1A4):
        heur = P.compile_model(params, SPEC, q, batch_hints=(1, 4),
                               img_hw=IMG)
        tuned = P.compile_model(params, SPEC, q, batch_hints=(1, 4),
                                img_hw=IMG, autotune=True)
        assert not heur.autotune
        for lp in tuned.layers:
            if lp.fp:
                continue
            assert lp.engine_source == "autotuned"
            for b, eng in lp.engines:
                conv = ops.ConvShape(lp.in_h, lp.in_w, lp.kh, lp.kw,
                                     lp.stride, lp.padding, batch=b)
                m = b * lp.out_h * lp.out_w
                assert eng in ops.candidate_engines(m, lp.k, lp.cout,
                                                    lp.a_bits, lp.w_bits,
                                                    conv=conv)
                key = ops.autotune_key(m, lp.k, lp.cout, lp.a_bits,
                                       lp.w_bits, "cpu", conv)
                assert tuned.autotune[key][0] == eng
        assert torch.equal(P.plan_forward(tuned, x), P.plan_forward(heur, x))
        path = P.save_plan(tuned, str(tmp_path / q.tag()))
        ops.clear_plan_state()

        def _no_measuring(*a, **kw):
            raise AssertionError("a reload measured")

        with monkeypatch.context() as mp:
            mp.setattr(ops, "_time_engine", _no_measuring)
            back = P.load_plan(path, device="cpu")
            assert back.autotune == tuned.autotune
            assert back.fingerprint() == tuned.fingerprint()
            assert [lp.engines for lp in back.layers] == [
                lp.engines for lp in tuned.layers]
            assert torch.equal(P.plan_forward(back, x),
                               P.plan_forward(heur, x))
            # the restored verdicts make a recompile measure nothing too
            again = P.compile_model(params, SPEC, q, batch_hints=(1, 4),
                                    img_hw=IMG, autotune=True)
            assert again.autotune == tuned.autotune


def test_structure_only_autotune_keys_name_the_target_device(monkeypatch):
    """With no params the measurement runs on the target's own device: on
    the cuda target that is the card, never silently the CPU."""
    seen = []
    monkeypatch.setattr(ops, "_time_engine",
                        lambda fn, *a, **kw: seen.append(kw["device"]) or 1.0)
    monkeypatch.setattr(ops, "quant_conv_serve", lambda *a, **kw: None)
    real_from_numpy = torch.from_numpy

    class _Lazy:
        def __init__(self, a):
            self.a = a

        def to(self, device):
            seen.append(torch.device(device))
            return real_from_numpy(self.a)

    monkeypatch.setattr(torch, "from_numpy", _Lazy)
    plan = P.compile_model(None, SPEC, quant.W1A4, img_hw=IMG,
                           autotune=True)
    assert plan.autotune
    assert all(k[-1] == "cuda" for k in plan.autotune)
    assert seen and all(torch.device(d).type == "cuda" for d in seen)


# ---------------------------------------------------------------------------
# the signed LM engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a_bits,w_bits", [(8, 1), (4, 1), (4, 4), (8, 3)])
@pytest.mark.parametrize("a_scale", [None, "row", 0.02])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_signed_engines_equal_bit_for_bit(a_bits, w_bits, a_scale, dtype):
    rs = np.random.RandomState(a_bits * 10 + w_bits)
    k, n = 96, 40
    a = rs.randn(3, 5, k).astype(np.float32)
    w_lv = rs.randint(0, 1 << w_bits, size=(k, n)).astype(np.int8)
    s_w = np.float32(0.03)
    z_w = np.float32(((1 << w_bits) - 1) / 2)
    tdt = dict(float32=torch.float32, bfloat16=torch.bfloat16)[dtype]
    jdt = dict(float32=jnp.float32, bfloat16=jnp.bfloat16)[dtype]
    ta = torch.from_numpy(a).to(tdt)
    outs = {eng: aa.quant_dense_forward_signed_pre(
        ta, torch.from_numpy(w_lv), torch.tensor(s_w), torch.tensor(z_w),
        a_bits, w_bits, a_scale=a_scale, engine=eng)
        for eng in aa.SIGNED_ENGINES}
    for eng, out in outs.items():
        assert torch.equal(out, outs["int8"]), eng
    ref = jax.jit(lambda x: jaa.quant_dense_forward_signed_pre(
        x, jnp.asarray(w_lv), jnp.asarray(s_w), jnp.asarray(z_w), a_bits,
        w_bits, engine="int8", a_scale=a_scale))(jnp.asarray(a, jdt))
    np.testing.assert_array_equal(outs["int8"].float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_signed_engine_follows_the_plan_table(monkeypatch):
    """``qdense`` asks the dispatcher (plan table first) for its signed
    engine and maps the unsigned picks to int8."""
    from repro_torch.models import layers as L

    x = torch.randn(2, 3, 64)
    q = quant.PAPER_CONFIGS["w1a8"]
    assert L._signed_engine(x, 32, q) == "int8"
    ops.install_plan_table({ops.dense_plan_key(64, 32, 8, 1, "cuda"):
                            "packed"})
    assert L._signed_engine(x, 32, q) == "packed"
    ops.install_plan_table({ops.dense_plan_key(64, 32, 8, 1, "cuda"):
                            "faithful"})
    assert L._signed_engine(x, 32, q) == "int8"
    assert L._signed_engine(x, 32, dataclasses.replace(
        q, engine="f32dot")) == "f32dot"
    with pytest.raises(ValueError, match="signed level engine"):
        aa.quant_dense_forward_signed_pre(
            x, torch.zeros(64, 32, dtype=torch.int8), torch.tensor(1.0),
            torch.tensor(0.5), 8, 1, engine="fused")
