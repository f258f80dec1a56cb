"""Plan artifacts of the port (``repro_torch.core.plan``,
``repro_torch.api``, ``repro_torch.convert.plan_from_reference``,
``repro_torch.launch.plan_smoke``) held to the reference's contracts.

* identity: the port's ``meta()`` for a ``cuda`` compile equals the
  reference's for the same ``tpu`` compile, with the two fields that
  differ by design masked (``backend``, and each layer's ``cost``, which
  comes from the target's constants);
* the ``cuda`` target's ``cost()`` is the reference's formula: given the
  reference TPU target's constants it gives the reference's floats;
* a save/load round trip reloads without requantizing (weight
  quantization patched to raise) and serves logits equal bit for bit,
  with an equal fingerprint, in this process and in a fresh one;
* a plan the reference's ``save_plan`` wrote (``tpu``) serves through
  ``plan_from_reference`` logits equal bit for bit to the port's own
  compile of the same levels, with an equal fingerprint; a ``cpu`` plan
  is refused;
* the version gate and every ``check_plan_matches`` error.

Everything runs here on the CPU (the kernels' plain versions); svhn(16)
at 16x16.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.api import targets as jtargets  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core.prequant import prequantize_cnn_params  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.api import targets  # noqa: E402
from repro_torch.core import plan as P  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 16
WIDTH = 16
MODELS = {"svhn": (lambda: jcnn.svhn_cnn_spec(), cnn.svhn_cnn_spec, 40),
          "alexnet": (jcnn.alexnet_spec, cnn.alexnet_spec, 224)}
QUANTS = {"w1a1": quant.W1A1, "w1a4": quant.W1A4, "w1a8": quant.W1A8,
          "w8a8": quant.QuantConfig(8, 8, 8),
          "w1a1_faithful": dataclasses.replace(quant.W1A1, engine="faithful")}


def _jq(q):
    return jquant.QuantConfig(**dataclasses.asdict(q))


def _masked(meta):
    m = json.loads(json.dumps(meta))
    m.pop("backend")
    for lp in m["layers"]:
        lp.pop("cost")
    return m


def _np_params(spec, seed=0):
    rs = np.random.RandomState(seed)
    return [dict(w=(rs.normal(size=(s.k, s.k, s.cin, s.cout))
                    / np.sqrt(s.k * s.k * s.cin)).astype(np.float32),
                 b=(0.1 * rs.normal(size=s.cout)).astype(np.float32),
                 g=np.ones(s.cout, np.float32),
                 beta=np.zeros(s.cout, np.float32)) for s in spec]


def _images(n=4, seed=1):
    return torch.from_numpy(np.random.RandomState(seed).uniform(
        0, 1, (n, IMG, IMG, 3)).astype(np.float32))


def _svhn_plan(q=quant.W1A4, seed=0, **kw):
    spec = cnn.svhn_cnn_spec(WIDTH)
    params = cnn.init_cnn(torch.Generator().manual_seed(seed), spec)
    return P.compile_model(params, spec, q, batch_hints=(1, 4), img_hw=IMG,
                           **kw)


def _forbid_requantization(monkeypatch):
    import repro_torch.core.prequant as prequant_mod
    import repro_torch.core.quant as quant_mod

    def boom(*a, **kw):
        raise AssertionError("weight_levels called")

    monkeypatch.setattr(quant_mod, "weight_levels", boom)
    monkeypatch.setattr(prequant_mod, "weight_levels", boom)


# ---------------------------------------------------------------------------
# identity and costs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["svhn", "alexnet"])
@pytest.mark.parametrize("qname", ["w1a1", "w1a4", "w1a8", "w1a1_faithful"])
def test_meta_equals_reference_tpu_meta_with_backend_and_cost_masked(
        model, qname):
    jspec, tspec, hw = MODELS[model]
    q = QUANTS[qname]
    tp = P.compile_model(None, tspec(), q, target="cuda", batch_hints=(1, 8),
                         img_hw=hw, model=model)
    jp = jplan.compile_model(None, jspec(), _jq(q), backend="tpu",
                             batch_hints=(1, 8), img_hw=hw, model=model,
                             verify=False)
    assert _masked(tp.meta()) == _masked(jp.meta())
    assert tp.meta()["backend"] == "cuda" and jp.meta()["backend"] == "tpu"
    assert all(len(lp.cost) == 3 and lp.cost[0] > 0 for lp in tp.layers)
    assert set(tp.meta()) == set(jp.meta())


def test_fingerprint_is_the_metadata_hash():
    a = P.compile_model(None, cnn.svhn_cnn_spec(WIDTH), quant.W1A4,
                        batch_hints=(1, 4), img_hw=IMG)
    b = P.compile_model(None, cnn.svhn_cnn_spec(WIDTH), quant.W1A4,
                        batch_hints=(1, 4), img_hw=IMG)
    c = P.compile_model(None, cnn.svhn_cnn_spec(WIDTH), quant.W1A8,
                        batch_hints=(1, 4), img_hw=IMG)
    assert a.fingerprint() == b.fingerprint() != c.fingerprint()
    assert len(a.fingerprint()) == 12
    # a plan whose meta equals the reference's in every field hashes alike
    j = jplan.compile_model(None, jcnn.svhn_cnn_spec(WIDTH), jquant.W1A4,
                            backend="tpu", batch_hints=(1, 4), img_hw=IMG,
                            verify=False)
    j = dataclasses.replace(j, backend="cuda", layers=tuple(
        dataclasses.replace(jl, cost=tl.cost)
        for jl, tl in zip(j.layers, a.layers)))
    assert j.fingerprint() == a.fingerprint()


@pytest.mark.parametrize("m,k,n", [(1600, 576, 64), (1, 9216, 4096),
                                   (3025, 363, 96), (7, 5, 3)])
@pytest.mark.parametrize("bits", [(1, 1), (4, 1), (8, 1), (8, 8), (2, 2)])
def test_cuda_cost_is_the_reference_formula(m, k, n, bits):
    tpu = jtargets.get_target("tpu")
    consts = {f: getattr(tpu, f) for f in ("clock_ghz", "flops_per_cycle",
                                           "bytes_per_cycle", "pj_per_flop",
                                           "pj_per_byte")}
    t = dataclasses.replace(targets.CUDA, **consts)
    got = t.cost(targets.LayerGeometry(m, k, n), *bits)
    ref = tpu.cost(jtargets.LayerGeometry(m, k, n), *bits)
    assert (got.energy_pj, got.cycles, got.bytes_moved) == (
        ref.energy_pj, ref.cycles, ref.bytes_moved)
    # the port's own constants are the H100's, none of the TPU's
    assert all(getattr(targets.CUDA, f) != v for f, v in consts.items())


def test_cuda_constants_come_from_the_h100_data_sheet():
    c = targets.CUDA
    assert c.clock_ghz * 1e9 * c.flops_per_cycle == pytest.approx(1.979e15)
    assert c.clock_ghz * 1e9 * c.bytes_per_cycle == pytest.approx(3.35e12)
    assert c.pj_per_flop * 1.979e15 * 1e-12 == pytest.approx(700.0)
    assert c.pj_per_byte * 3.35e12 * 1e-12 == pytest.approx(700.0)
    assert targets.target_for_backend("tpu") is c
    assert targets.target_for_backend("cuda") is c
    assert targets.target_for_backend("sot_mram") is c


def test_plan_energy_is_the_sum_of_layer_costs():
    p8 = _svhn_plan(quant.W1A8)
    p1 = _svhn_plan(quant.W1A1)
    assert P.plan_energy_pj(p8) == sum(lp.cost[0] for lp in p8.layers) > 0
    assert 0 < P.plan_energy_pj(p1) < P.plan_energy_pj(p8)
    bare = dataclasses.replace(p8, layers=tuple(
        dataclasses.replace(lp, cost=()) for lp in p8.layers))
    assert P.plan_energy_pj(bare) == 0.0


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qname", ["w1a4", "w1a8", "w8a8", "w1a1_faithful"])
def test_save_load_round_trip_never_requantizes(qname, tmp_path,
                                                monkeypatch):
    plan = _svhn_plan(QUANTS[qname])
    x = _images()
    want = P.plan_forward(plan, x)
    path = P.save_plan(plan, str(tmp_path / "svhn"))
    assert path.endswith(".json") and P.plan_exists(str(tmp_path / "svhn"))
    assert P.plan_exists(path)
    _forbid_requantization(monkeypatch)
    with pytest.raises(AssertionError, match="weight_levels"):
        _svhn_plan(QUANTS[qname])            # the guard does catch
    got = P.load_plan(path, device="cpu")
    assert got.fingerprint() == plan.fingerprint()
    assert got.meta() == plan.meta()
    assert torch.equal(P.plan_forward(got, x), want)
    for a, b in zip(plan.params, got.params):
        assert set(a) == set(b)
        for k in a:
            if torch.is_tensor(a[k]):
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
            else:
                assert a[k] == b[k] and isinstance(b[k], float)


def test_reference_reads_the_ports_plan_layout(tmp_path):
    plan = _svhn_plan(quant.W1A4)
    path = P.save_plan(plan, str(tmp_path / "svhn"))
    ref = jplan.load_plan(path)
    assert ref.meta() == plan.meta()
    assert ref.fingerprint() == plan.fingerprint()


def test_structure_only_plan_round_trip(tmp_path):
    plan = P.compile_model(None, cnn.svhn_cnn_spec(WIDTH), quant.W1A4,
                           img_hw=IMG)
    got = P.load_plan(P.save_plan(plan, str(tmp_path / "bare")),
                      device="cpu")
    assert got.params is None and got.fingerprint() == plan.fingerprint()


def _reference_plan(tmp_path, q, backend="tpu"):
    jspec = jcnn.svhn_cnn_spec(WIDTH)
    levels = jax.jit(lambda p: prequantize_cnn_params(p, jspec, _jq(q)))(
        _np_params(jspec))
    jp = jplan.compile_model(levels, jspec, _jq(q), backend=backend,
                             batch_hints=(1, 4), img_hw=IMG, verify=False)
    path = jplan.save_plan(jp, str(tmp_path / f"ref_{backend}"))
    tparams = convert.cnn_params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jp.params], "cpu")
    own = P.compile_model(tparams, cnn.svhn_cnn_spec(WIDTH), q,
                          batch_hints=(1, 4), img_hw=IMG)
    return jp, path, own


@pytest.mark.parametrize("qname", ["w1a4", "w1a8", "w8a8", "w1a1_faithful"])
def test_reference_tpu_plan_serves_like_the_ports_own_compile(qname,
                                                              tmp_path,
                                                              monkeypatch):
    q = QUANTS[qname]
    jp, path, own = _reference_plan(tmp_path, q)
    lv = [np.asarray(p["w_lv"]) for p in jp.params if "w_lv" in p]
    assert {a.dtype for a in lv} == {np.dtype(np.int32 if q.w_bits == 8
                                              else np.int8)}
    _forbid_requantization(monkeypatch)
    got = convert.plan_from_reference(path, device="cpu")
    assert got.backend == "cuda" and got.autotune == {}
    assert got.fingerprint() == own.fingerprint()
    assert all(p["w_lv"].dtype == torch.uint8 for p in got.params
               if "w_lv" in p)
    if q.engine == "faithful":
        assert all("w_planes" in p for p, lp in zip(got.params, got.layers)
                   if not lp.fp)
    x = _images()
    assert torch.equal(P.plan_forward(got, x), P.plan_forward(own, x))


def test_reference_cpu_plan_is_refused(tmp_path):
    _, path, _ = _reference_plan(tmp_path, quant.W1A4, backend="cpu")
    with pytest.raises(P.PlanError, match="recompile"):
        convert.plan_from_reference(path, device="cpu")


def test_reference_levels_out_of_range_are_refused(tmp_path):
    jp, path, _ = _reference_plan(tmp_path, quant.W1A4)
    npz = os.path.join(str(tmp_path), "ref_tpu.npz")
    arrays = dict(np.load(npz))
    key = next(k for k, v in arrays.items() if k.endswith("/w_lv"))
    arrays[key] = arrays[key].copy()
    arrays[key].flat[0] = 2            # a 1-bit layer holds levels 0 and 1
    np.savez(npz, **arrays)
    with pytest.raises(P.PlanError, match="outside"):
        convert.plan_from_reference(path, device="cpu")


def test_version_gate_and_kind(tmp_path):
    plan = _svhn_plan()
    path = P.save_plan(plan, str(tmp_path / "svhn"))
    meta = json.load(open(path))
    for field, value, match in (("version", 2, "version"),
                                ("kind", "rnn", "kinds")):
        bad = dict(meta, **{field: value})
        bad_path = str(tmp_path / f"bad_{field}.json")
        json.dump(bad, open(bad_path, "w"))
        with pytest.raises(P.PlanError, match=match):
            P.load_plan(bad_path, device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(quant=quant.W1A8), "quant"),
    (dict(quant=dataclasses.replace(quant.W1A4, engine="fused")), "engine"),
    (dict(model="alexnet"), "model"),
    (dict(backend="tpu"), "backend")])
def test_check_plan_matches_errors(kw, match):
    plan = _svhn_plan()
    with pytest.raises(P.PlanError, match=match):
        P.check_plan_matches(plan, **kw)
    assert P.check_plan_matches(plan, quant=quant.W1A4, model="cnn",
                                backend="cuda") is plan


# ---------------------------------------------------------------------------
# the facade and the smoke gate
# ---------------------------------------------------------------------------

def test_compile_cache_reloads_the_second_time(tmp_path, monkeypatch):
    spec = cnn.svhn_cnn_spec(WIDTH)
    params = cnn.init_cnn(torch.Generator().manual_seed(3), spec)
    model = api.build(spec, quant.W1A4, params=params, img_hw=IMG,
                      name="svhn16")
    cache = str(tmp_path / "plans" / "svhn16")
    first = model.compile(batch_hints=(1, 4), cache=cache)
    assert not first.reloaded and first.cache_path == cache + ".json"
    assert first.compile_s > 0
    _forbid_requantization(monkeypatch)
    second = model.compile(batch_hints=(1, 4), cache=cache)
    assert second.reloaded and second.fingerprint() == first.fingerprint()
    assert second.quant == quant.W1A4 and second.model is model
    x = _images()
    assert torch.equal(second.forward(x), first.forward(x))
    with pytest.raises(P.PlanError, match="quant"):
        api.build(spec, quant.W1A8, params=params, img_hw=IMG,
                  name="svhn16").compile(cache=cache)
    loaded = api.load(cache, spec=spec, quant=quant.W1A4, device="cpu")
    assert loaded.reloaded and loaded.model.name == "svhn16"
    assert loaded.model.kind == "cnn"
    assert torch.equal(loaded.forward(x), first.forward(x))


def test_deployment_queue_passthroughs_and_report_rows(tmp_path):
    compiled = api.build(cnn.svhn_cnn_spec(WIDTH), quant.W1A4,
                         params=cnn.init_cnn(torch.Generator().manual_seed(0),
                                             cnn.svhn_cnn_spec(WIDTH)),
                         img_hw=IMG).compile(batch_hints=(1, 4))
    dep = compiled.serve(max_batch=4)
    imgs = [im.numpy() for im in _images(3)]
    rids = [dep.submit(im) for im in imgs]
    dep.pump()
    res = dep.drain()
    assert [r.rid for r in res] == rids
    rows = compiled.simulate("sot_mram").rows()
    ref = japi.build(jcnn.svhn_cnn_spec(WIDTH), jquant.W1A4,
                     img_hw=IMG).compile(target="cpu", verify=False).simulate(
        "sot_mram").rows()
    assert rows == ref


@pytest.mark.parametrize("kw", [dict(autotune=True), dict(verify=True)])
def test_unported_compile_options_raise(kw, tmp_path):
    """Both options are ported (each raised before its slice).  Autotune
    times the candidates on the params' device (here the CPU) and keeps
    the measurements in the plan.  ``verify=True`` (the default) proves
    the plan it returns, and a hand-edited ``cache=`` artifact (the 1x1
    conv6 pinned to ``implicit``) is refused with
    ``PlanVerificationError``, a ``PlanError``, before any kernel runs;
    ``verify=False`` reloads it unproven."""
    from repro_torch.analysis.prover import (PlanVerificationError,
                                             verify_plan)
    from repro_torch.kernels import _lib, ops

    spec = cnn.svhn_cnn_spec(WIDTH)
    model = api.build(spec, quant.W1A4, img_hw=IMG, params=cnn.init_cnn(
        torch.Generator().manual_seed(0), spec))
    if kw.get("verify"):
        compiled = model.compile(**kw)
        assert verify_plan(compiled.plan) == [] and not compiled.reloaded
        path = compiled.save(str(tmp_path / "svhn"))
        with open(path) as f:
            meta = json.load(f)
        row = meta["layers"][6]
        assert (row["kh"], row["fp"]) == (1, False)
        row["engine"] = "implicit"
        row["engines"] = [[b, "implicit"] for b, _ in row["engines"]]
        with open(path, "w") as f:
            json.dump(meta, f)
        before = dict(_lib.LAUNCHES)
        with pytest.raises(PlanVerificationError, match="PV103") as ei:
            model.compile(cache=path, **kw)
        assert isinstance(ei.value, P.PlanError)
        assert _lib.LAUNCHES == before
        unproven = model.compile(cache=path, verify=False)
        assert unproven.reloaded and unproven.plan.layers[6].engine == \
            "implicit"
        return

    ops.clear_plan_state()
    compiled = model.compile(**kw)
    tuned = [lp for lp in compiled.plan.layers if not lp.fp]
    assert tuned and all(lp.engine_source == "autotuned" for lp in tuned)
    assert compiled.plan.autotune
    assert all(k[-1] == "cpu" for k in compiled.plan.autotune)
    ops.clear_plan_state()


def test_lm_session_raises():
    """``build(cfg)`` of an ArchConfig opens an LM session (it raised
    before LM plans were ported): kind "lm", the config's own quant unless
    overridden."""
    from repro_torch.configs import get_config

    cfg = get_config("smollm-360m")
    m = api.build(cfg)
    assert m.kind == "lm" and m.quant == cfg.quant and m.name == cfg.name
    m8 = api.build(cfg, quant.W1A8)
    assert m8.kind == "lm" and m8.quant == quant.W1A8
    assert m8.spec.quant == quant.W1A8
    with pytest.raises(TypeError):
        api.build(cnn.svhn_cnn_spec(WIDTH))


def test_plan_smoke_cpu_in_a_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.plan_smoke", "--device",
         "cpu", "--out", str(tmp_path / "smoke")],
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert "PLAN SMOKE OK" in p.stdout
    row = json.loads(p.stdout.strip().splitlines()[-1])
    assert row["device"] == "cpu" and row["load_ms"] > 0
    assert row["compile_ms"] > 0
