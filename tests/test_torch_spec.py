"""Port parity: the legacy served CNN entry point
(``cnn_forward(mode="serve")``), the paper's analytic model walked from a
spec (``pim.mapper.layer_work`` / ``model_work`` / ``compare_designs``,
``models.cnn.count_*``, Fig. 8's ``model_storage_bits``, Table I's
complexity), and the smaller API (``fake_quant_act``,
``fake_quant_dense_weight``, ``serve_weight_bytes``,
``ContinuousLMEngine.warm``, ``CNNRunner.plan_fingerprint``, ``launch.serve
--prequant``, ``launch.train --multi-pod``).

Tolerances, and why:

* the served forward against the jitted reference on the reference's own
  levels: equal argmax and max |dlogit| within twice the reference's own
  jit-vs-eager drift, floor 2e-3 (``test_torch_forward.py``'s rule: the
  same .5-boundary level flips happen inside the reference);
* against the port's own compiled forward, and the faithful engine
  against the default engines: bit for bit (the same levels, the same
  int32 accumulator, one epilogue);
* the spec walk, the counts and the storage model: the reference's floats
  and integers exactly (the same arithmetic in the same order);
* ``fake_quant_act``: values and gradients exact; ``fake_quant_dense_weight``:
  values within SCALE_ULPS of the reference's largest (its 1-bit scale
  ``2 mean|w|`` is the correctly rounded float64 mean, XLA's float32 sum
  lands up to 13 ulps away; ``test_torch_quant.py``), gradients within
  1e-6 x max|g| (``test_torch_train_quant.py``).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.api import reports as jreports  # noqa: E402
from repro.core import prequant as jprequant  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.pim import mapper as jmapper  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.api import reports  # noqa: E402
from repro_torch.core import plan as plan_mod  # noqa: E402
from repro_torch.core import prequant, quant  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.pim import mapper  # noqa: E402
from repro_torch.pim.energy import DESIGNS, TABLE2_AREA_MM2  # noqa: E402

from test_torch_train_cnn import np_params, one_torch_thread  # noqa: E402,F401

DRIFT_FLOOR = 2e-3
WIDTH, HW, BATCH = 8, 16, 2
SCALE_ULPS = 16
GRAD_TOL = 1e-6       # x max|g|
SERVE_CASES = {"w1a4": "auto", "w1a8": "auto", "w1a1": "faithful"}
WALK_BITS = [(1, 1), (8, 1), (2, 2)]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _image(seed: int = 3) -> np.ndarray:
    return np.random.RandomState(seed).uniform(
        0, 1, (BATCH, HW, HW, 3)).astype(np.float32)


def _quants(qname: str):
    eng = SERVE_CASES[qname]
    return (dataclasses.replace(jquant.PAPER_CONFIGS[qname], engine=eng),
            dataclasses.replace(quant.PAPER_CONFIGS[qname], engine=eng))


# ---------------------------------------------------------------------------
# (a) the served forward against the jitted reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qname", list(SERVE_CASES))
def test_serve_forward_within_reference_drift(qname):
    """On the reference's own prequantized levels (carried across by
    ``convert``), the port's ``cnn_forward(..., "serve")`` against the
    reference's, jitted, with params as arguments."""
    jspec, tspec = jcnn.svhn_cnn_spec(WIDTH), cnn.svhn_cnn_spec(WIDTH)
    jq, tq = _quants(qname)
    levels = jax.jit(lambda p: jprequant.prequantize_cnn_params(
        p, jspec, jq))(np_params(jspec, seed=5))
    x = _image()
    ref = np.asarray(jax.jit(lambda p, v: jcnn.cnn_forward(
        p, v, jspec, jq, "serve"))(levels, x))
    eager = np.asarray(jcnn.cnn_forward(levels, jnp.asarray(x), jspec, jq,
                                        "serve"))
    tol = max(2.0 * float(np.abs(ref - eager).max()), DRIFT_FLOOR)
    tparams = convert.cnn_params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in levels], "cpu")
    got = cnn.cnn_forward(tparams, _t(x), tspec, tq, "serve").numpy()
    assert got.shape == ref.shape == (BATCH, 10) and np.isfinite(got).all()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    assert np.abs(got - ref).max() <= tol


# ---------------------------------------------------------------------------
# (b) against the port's own compiled forward
# ---------------------------------------------------------------------------

def _float_params(spec, seed=7):
    return convert.cnn_params_from_numpy(np_params(spec, seed), "cpu")


@pytest.mark.parametrize("qname", ["w1a1", "w1a4", "w1a8", "w2a2"])
def test_serve_forward_equals_the_compiled_forward(qname):
    """From float params (prequantized at the call) and from the plan's
    prequantized params, bit for bit the compiled plan's logits."""
    spec, q = cnn.svhn_cnn_spec(WIDTH), quant.PAPER_CONFIGS[qname]
    params, x = _float_params(spec), _t(_image(4))
    compiled = api.build(spec, q, params=params, img_hw=HW).compile(
        batch_hints=(BATCH,))
    want = compiled.forward(x)
    assert torch.equal(cnn.cnn_forward(params, x, spec, q, "serve"), want)
    assert torch.equal(cnn.cnn_forward(compiled.params, x, spec, q, "serve"),
                       want)


def test_faithful_serve_equals_the_default_engines():
    """The faithful W1A1 legacy call (weight planes packed at the call)
    equals the default engines' call bit for bit, on float and on
    prequantized params."""
    spec, x = cnn.svhn_cnn_spec(WIDTH), _t(_image(5))
    params = _float_params(spec, 8)
    faithful = dataclasses.replace(quant.W1A1, engine="faithful")
    layers = plan_mod.cnn_serve_layers(spec, faithful, batch=BATCH,
                                       img_hw=(HW, HW))
    assert [lp.engine for lp in layers if not lp.fp] == ["faithful"] * 6
    want = cnn.cnn_forward(params, x, spec, quant.W1A1, "serve")
    assert torch.equal(cnn.cnn_forward(params, x, spec, faithful, "serve"),
                       want)
    pre = prequant.prequantize_cnn_params(params, spec, faithful)
    assert not any("w_planes" in p for p in pre)
    assert torch.equal(cnn.cnn_forward(pre, x, spec, faithful, "serve"),
                       want)


# ---------------------------------------------------------------------------
# (c) the per-call plan's cache and the modes
# ---------------------------------------------------------------------------

def test_serve_layers_cached_per_call_and_keyed_by_dispatch_epoch():
    spec, q = cnn.svhn_cnn_spec(WIDTH), quant.W1A4
    params, x = _float_params(spec), _t(_image())
    plan_mod._cached_cnn_layers.cache_clear()
    first = cnn.cnn_forward(params, x, spec, q, "serve")
    info = plan_mod._cached_cnn_layers.cache_info()
    assert (info.hits, info.misses) == (0, 1)
    assert torch.equal(cnn.cnn_forward(params, x, spec, q, "serve"), first)
    assert plan_mod._cached_cnn_layers.cache_info().hits == 1
    ops.install_plan_table({})              # bumps the dispatch epoch
    assert torch.equal(cnn.cnn_forward(params, x, spec, q, "serve"), first)
    assert plan_mod._cached_cnn_layers.cache_info().misses == 2
    # the per-call plan makes the compiled plan's engine choices
    compiled = plan_mod.compile_model(None, spec, q, batch_hints=(BATCH,),
                                      img_hw=HW)
    layers = plan_mod.cnn_serve_layers(spec, q, batch=BATCH, img_hw=(HW, HW))
    assert [lp.engine for lp in layers] == [
        lp.engine for lp in compiled.layers]


def test_explicit_engine_taken_unchecked_by_the_per_call_plan():
    """A compiled plan refuses an infeasible explicit engine; the per-call
    plan takes it as given (it fails at its kernel's wrapper on the card,
    never on another engine)."""
    spec = [cnn.ConvSpec(3, 8, 3, role="first"), cnn.ConvSpec(8, 8, 3,
                                                              stride=3),
            cnn.ConvSpec(8, 10, 1, role="last")]
    q = dataclasses.replace(quant.W1A4, engine="implicit")
    with pytest.raises(plan_mod.PlanError, match="infeasible"):
        plan_mod.compile_model(None, spec, q, img_hw=HW)
    layers = plan_mod.cnn_serve_layers(spec, q, batch=BATCH, img_hw=(HW, HW))
    assert layers[1].engine == "implicit"
    assert layers[1].engine_source == "override"


def test_every_other_mode_is_the_training_forward():
    spec, x = cnn.svhn_cnn_spec(WIDTH), _t(_image())
    params = _float_params(spec)
    train = cnn.cnn_forward(params, x, spec, quant.W1A4, "train")
    assert torch.equal(cnn.cnn_forward(params, x, spec, quant.W1A4, "eval"),
                       train)
    assert not torch.equal(
        cnn.cnn_forward(params, x, spec, quant.W1A4, "serve"), train)


# ---------------------------------------------------------------------------
# (d) the spec walk
# ---------------------------------------------------------------------------

def _specs(name: str):
    return jreports.DATASETS[name]["spec"](), reports.DATASETS[name]["spec"]()


@pytest.mark.parametrize("name", list(reports.DATASETS))
@pytest.mark.parametrize("bits", WALK_BITS)
def test_spec_walk_equals_the_reference_exactly(name, bits):
    jspec, tspec = _specs(name)
    img = reports.DATASETS[name]["img"]
    assert img == jreports.DATASETS[name]["img"]
    m_b, n_b = bits
    hw_j = hw_t = img
    for js, ts in zip(jspec, tspec, strict=True):
        jw, hw_j = jmapper.layer_work(js, hw_j, m_b, n_b)
        tw, hw_t = mapper.layer_work(ts, hw_t, m_b, n_b)
        assert dataclasses.astuple(tw) == dataclasses.astuple(jw)
        assert hw_t == hw_j
    for fl in (True, False):
        got = mapper.model_work(tspec, img, m_b, n_b, fl)
        ref = jmapper.model_work(jspec, img, m_b, n_b, fl)
        assert [dataclasses.astuple(w) for w in got] == [
            dataclasses.astuple(w) for w in ref]
    for area in (None, TABLE2_AREA_MM2):
        got = mapper.compare_designs(tspec, img, m_b, n_b, area)
        ref = jmapper.compare_designs(jspec, img, m_b, n_b, area)
        assert list(got) == list(ref) == list(DESIGNS)
        for d in ref:
            assert got[d] == ref[d], d       # every float, exactly
        assert ("fps_per_mm2" in got["proposed"]) == (area is not None)
    plan = plan_mod.compile_model(
        None, tspec, quant.QuantConfig(w_bits=n_b, a_bits=m_b, g_bits=8),
        img_hw=img)
    assert mapper.works_from_layers(plan.layers) == mapper.model_work(
        tspec, img, m_b, n_b)


def test_layer_work_refuses_an_empty_extent():
    with pytest.raises(ValueError, match="input extent must be >= 1"):
        mapper.layer_work(cnn.svhn_cnn_spec()[1], 0, 1, 1)


# ---------------------------------------------------------------------------
# (e) the counting functions, the storage model, the complexity
# ---------------------------------------------------------------------------

COUNT_MODELS = {
    **{f"svhn{c}": (lambda c=c: jcnn.svhn_cnn_spec(c),
                    lambda c=c: cnn.svhn_cnn_spec(c), 40) for c in (8, 20, 64)},
    "alexnet": (jcnn.alexnet_spec, cnn.alexnet_spec, 224),
    "lenet": (jreports.lenet_spec, reports.lenet_spec, 28),
}


@pytest.mark.parametrize("model", list(COUNT_MODELS))
def test_counts_and_storage_equal_the_reference(model):
    jfn, tfn, img = COUNT_MODELS[model]
    jspec, tspec = jfn(), tfn()
    p, a = cnn.count_params(tspec), cnn.count_acts(tspec, img)
    assert p == jcnn.count_params(jspec)
    assert a == jcnn.count_acts(jspec, img)
    assert cnn.count_macs(tspec, img) == jcnn.count_macs(jspec, img)
    for qname, q in quant.PAPER_CONFIGS.items():
        assert quant.model_storage_bits(p, a, q.w_bits, q.a_bits) == \
            jquant.model_storage_bits(p, a, q.w_bits, q.a_bits), qname


@pytest.mark.parametrize("qname", list(quant.PAPER_CONFIGS))
def test_table1_complexity_equals_the_reference(qname):
    q, jq = quant.PAPER_CONFIGS[qname], jquant.PAPER_CONFIGS[qname]
    assert q.inference_complexity == jq.inference_complexity == \
        q.w_bits * q.a_bits
    assert q.training_complexity == jq.training_complexity == \
        q.w_bits * q.a_bits + q.w_bits * q.g_bits


# ---------------------------------------------------------------------------
# (f) the paper's claims on the port alone (tests/test_pim.py's bounds)
# ---------------------------------------------------------------------------

def test_headline_speed_ratios():
    """IMCE 3x and ReRAM 9x speedups are structural (cycle counts)."""
    works = mapper.model_work(cnn.alexnet_spec(), 224, 1, 1)
    fps = {k: mapper.accel_cost(d, works)["fps"] for k, d in DESIGNS.items()}
    assert fps["proposed"] / fps["imce"] == pytest.approx(3.0, rel=0.15)
    assert fps["proposed"] / fps["reram"] == pytest.approx(9.0, rel=0.15)


def test_compressor_vs_serial_counter_is_the_win():
    """Give the proposed design IMCE's serial counter and its advantage
    collapses: the paper's central section II-B1 claim."""
    works = mapper.model_work(cnn.alexnet_spec(), 224, 1, 1)
    prop = DESIGNS["proposed"]
    crippled = dataclasses.replace(prop, c_cmp=DESIGNS["imce"].c_cmp,
                                   e_cmp_row=DESIGNS["imce"].e_cmp_row)
    fast = mapper.accel_cost(prop, works)
    slow = mapper.accel_cost(crippled, works)
    assert fast["fps"] / slow["fps"] == pytest.approx(3.0, rel=0.1)
    assert slow["energy_uj"] / fast["energy_uj"] > 1.5


def test_storage_model_fig8():
    spec = cnn.svhn_cnn_spec(20)
    p, a = cnn.count_params(spec), cnn.count_acts(spec, 40)
    s32 = quant.model_storage_bits(p, a, 32, 32)
    s14 = quant.model_storage_bits(p, a, 1, 4)
    assert 6 < s32 / s14 < 16  # paper: ~11.7x reduction for 1:4
    spec = cnn.alexnet_spec()
    ap, aa = cnn.count_params(spec), cnn.count_acts(spec, 224)
    pure = quant.model_storage_bits(ap, aa, 32, 32) / \
        quant.model_storage_bits(ap, aa, 1, 1)
    assert 16 < pure <= 32.5
    # deployment form: first and last layers fp32
    fl = sum(s.k * s.k * s.cin * s.cout for s in spec
             if s.role in ("first", "last"))
    deploy_bits = fl * 32 + (ap - fl) * 1 + aa * 8
    assert 4 < (ap + aa) * 32 / deploy_bits < 16  # paper's ~6x regime


# ---------------------------------------------------------------------------
# (g) the smaller API
# ---------------------------------------------------------------------------

def _grads(port_fn, ref_fn, x, cot):
    t = torch.from_numpy(x.copy()).requires_grad_()
    out = port_fn(t)
    (g,) = torch.autograd.grad(out, t, torch.from_numpy(cot))
    ref = jax.jit(lambda a, c: jax.grad(
        lambda z: jnp.sum(ref_fn(z) * c))(a))(x, cot)
    return out.detach().numpy(), g.numpy(), np.asarray(ref_fn(jnp.asarray(
        x))), np.asarray(ref)


@pytest.mark.parametrize("qname", ["w1a1", "w1a4", "w2a2", "w32a32"])
@pytest.mark.parametrize("first_last", [False, True])
def test_fake_quant_forms_equal_the_reference(qname, first_last):
    q, jq = quant.PAPER_CONFIGS[qname], jquant.PAPER_CONFIGS[qname]
    rs = np.random.RandomState(len(qname) + first_last)
    a = (rs.randn(6, 40) * 0.6 + 0.5).astype(np.float32)
    a[0, :8] = 0.0
    a[0, 8:16] = 1.0
    cot = rs.randn(*a.shape).astype(np.float32)
    got, g, ref, gref = _grads(
        lambda t: quant.fake_quant_act(t, q, first_last),
        lambda z: jquant.fake_quant_act(z, jq, first_last), a, cot)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(g, gref)
    w = (rs.randn(3, 3, 8, 16) * 0.3).astype(np.float32)
    cot = rs.randn(*w.shape).astype(np.float32)
    got, g, ref, gref = _grads(
        lambda t: quant.fake_quant_dense_weight(t, q, first_last),
        lambda z: jquant.fake_quant_dense_weight(z, jq, first_last), w, cot)
    np.testing.assert_allclose(
        got, ref, rtol=0,
        atol=SCALE_ULPS * float(np.spacing(np.abs(ref).max())))
    np.testing.assert_allclose(g, gref, rtol=0,
                               atol=GRAD_TOL * float(np.abs(gref).max()))
    keep = q.engine == "fp" or first_last
    wt = torch.from_numpy(w)
    assert (quant.fake_quant_dense_weight(wt, q, first_last) is wt) == keep
    at = torch.from_numpy(a)
    assert (quant.fake_quant_act(at, q, first_last) is at) == keep


@pytest.mark.parametrize("w_bits", [1, 2, 8])
def test_serve_weight_bytes(w_bits):
    """Equal to the reference's up to 7-bit weights; at 8 bits the port
    keeps levels in one byte where the reference keeps int32."""
    jspec, tspec = jcnn.svhn_cnn_spec(WIDTH), cnn.svhn_cnn_spec(WIDTH)
    q = quant.QuantConfig(w_bits=w_bits, a_bits=4)
    jq = jquant.QuantConfig(w_bits=w_bits, a_bits=4)
    raw = np_params(jspec, seed=2)
    ref = jprequant.serve_weight_bytes(jax.jit(
        lambda p: jprequant.prequantize_cnn_params(p, jspec, jq))(raw))
    fparams = convert.cnn_params_from_numpy(raw, "cpu")
    got = prequant.serve_weight_bytes(
        prequant.prequantize_cnn_params(fparams, tspec, q))
    assert prequant.serve_weight_bytes(fparams) == \
        jprequant.serve_weight_bytes(raw)
    lv_elems = sum(s.k * s.k * s.cin * s.cout for s in tspec
                   if not prequant.is_fp_layer(s, q))
    fp_bytes = 4 * sum(s.k * s.k * s.cin * s.cout for s in tspec
                       if prequant.is_fp_layer(s, q))
    assert got == fp_bytes + lv_elems
    if w_bits < 8:
        assert got == ref
    else:
        assert ref == fp_bytes + 4 * lv_elems


def test_cnn_runner_plan_fingerprint():
    from repro_torch.launch.engine import CNNRunner

    spec = cnn.svhn_cnn_spec(WIDTH)
    params = _float_params(spec)
    fps = []
    for q in (quant.W1A4, quant.W1A8):
        plan = api.build(spec, q, params=params, img_hw=HW).compile().plan
        runner = CNNRunner(plan)
        assert runner.plan_fingerprint() == plan.fingerprint()
        fps.append(runner.plan_fingerprint())
    assert fps[0] != fps[1]


def test_continuous_engine_warm_leaves_no_trace_in_results():
    from repro_torch.configs import SINGLE, get_config
    from repro_torch.launch.engine import ContinuousLMEngine
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import prequantize_params

    cfg = dataclasses.replace(get_config("smollm-360m").smoke(),
                              quant=quant.W1A8)
    params = prequantize_params(
        T.init_lm(torch.Generator().manual_seed(0), cfg, SINGLE, "cpu"), cfg)

    def engine():
        return ContinuousLMEngine(params, cfg, num_slots=2, page_size=4,
                                  num_pages=16, new_tokens=3)

    warm = engine()
    assert warm.warm() is warm
    assert warm.stats["requests"] == 1 and warm.stats["retirements"] == 1
    assert warm.program_shapes
    prompt = np.arange(1, 7, dtype=np.int32)
    got = warm.serve([prompt])
    ref = engine().serve([prompt])
    assert len(got) == 1
    np.testing.assert_array_equal(got[0].value, ref[0].value)


def _samples(out: str) -> list:
    return [ln for ln in out.splitlines() if "sample[" in ln]


def test_serve_cli_prequant_serves_the_same_tokens(capsys):
    """Without ``--prequant`` the CLI serves float weights through
    ``qdense``'s serve quantization, with it the weights quantized once
    at load: the same levels, so the same tokens."""
    from repro_torch.launch import serve

    base = ["--device", "cpu", "--smoke", "--quant", "w1a8", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "4"]
    serve.main(base)
    plain = capsys.readouterr().out
    serve.main(base + ["--prequant"])
    pre = capsys.readouterr().out
    assert "engine=serve\n" in plain and "engine=serve prequant" in pre
    assert _samples(plain) and _samples(plain) == _samples(pre)


def test_train_cli_multi_pod_raises_the_production_mesh_error():
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match=r"production mesh \(2, 16, 16\) "
                                           r"needs a world of 512 ranks"):
        train.main(["--arch", "smollm-360m", "--smoke", "--steps", "1",
                    "--device", "cpu", "--multi-pod"])
