"""LM execution plans in the port (``repro_torch.core.plan.compile_lm``,
the facade's LM session, ``LMRunner`` / ``ContinuousLMEngine`` /
``EpochLMRunner`` over a plan, ``launch.serve --plan-cache``,
``convert.plan_from_reference``) held to the reference's on the same
numpy-seeded params.

* ``compile_lm``'s dense table, attention table and layer rows equal the
  reference's ``tpu`` compile (the target the port's ``cuda`` one routes
  as), backend slot mapped; against the reference's ``cpu`` compile the
  dense (K, N) keys and the attention verdicts are equal (its dense
  verdicts are the CPU's float engine by design);
* a port LM plan round-trips through ``save_plan`` / ``load_plan`` with
  bit-equal params, and the reference's ``load_plan`` reads it with an
  equal fingerprint; a reference ``tpu`` plan serves through
  ``plan_from_reference`` the reference's tokens;
* ``api.build(cfg).compile().serve().predict`` gives the reference
  facade's tokens; the runners dispatch through the plan's tables;
* ``launch.serve --plan-cache`` twice: the second run reloads and
  generates the same tokens;
* the facade's resilient LM engine: its counters equal the reference
  engine's under the same ``FaultPlan``.

Geometry: the smollm-360m smoke config with the full model's GQA group of
3, W1A8, float32 compute; the kernels' plain versions (CPU).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.resilience import FaultPlan as JFaultPlan  # noqa: E402
from repro.resilience import ResilienceConfig as JResilienceConfig  # noqa: E402
from repro_torch import api, configs, convert  # noqa: E402
from repro_torch.core import plan as P  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.engine import ContinuousLMEngine  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.resilience import FaultPlan, ResilienceConfig  # noqa: E402

GEOM = dict(n_layers=2, d_model=64, n_heads=3, n_kv_heads=1, d_ff=128,
            vocab=64, head_dim=32)
PROMPT, NEW = 8, 5
COUNTERS = ("faults", "power_losses", "device_drops", "slow_dispatches",
            "staging_retries", "retries", "dead_lettered", "degrades",
            "recoveries", "prefills", "resumes", "epochs", "commits",
            "executed_steps", "useful_steps", "wasted_steps", "dispatches",
            "requests", "padded_rows")


def _numpy_params(seed: int = 0) -> dict:
    rs = np.random.RandomState(seed)
    n, d, hd = GEOM["n_layers"], GEOM["d_model"], GEOM["head_dim"]
    h, hk, ff = GEOM["n_heads"], GEOM["n_kv_heads"], GEOM["d_ff"]

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


@pytest.fixture(autouse=True)
def _clean_state():
    ops.clear_plan_state()
    jops.clear_plan_state()
    yield
    ops.clear_plan_state()
    jops.clear_plan_state()


@pytest.fixture(scope="module")
def lm():
    jcfg = dataclasses.replace(jconfigs.get_config("smollm-360m").smoke(**GEOM),
                               quant=jquant.PAPER_CONFIGS["w1a8"])
    cfg = dataclasses.replace(configs.get_config("smollm-360m").smoke(**GEOM),
                              quant=quant.PAPER_CONFIGS["w1a8"])
    raw = _numpy_params()
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, GEOM["vocab"], PROMPT).astype(np.int32)
               for _ in range(4)]
    return dict(cfg=cfg, jcfg=jcfg, raw=raw, prompts=prompts,
                jraw=jax.tree.map(jnp.asarray, raw),
                params=convert.lm_params_from_numpy(raw, cfg, device="cpu"))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _map_backend(key, backend):
    at = 5 if key[0] == "dense" else 7
    return key[:at] + (backend,) + key[at + 1:]


# ---------------------------------------------------------------------------
# compile_lm against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [None, (16, 3)], ids=["contiguous",
                                                        "paged"])
@pytest.mark.parametrize("backend", ["tpu", "cpu"])
def test_compile_lm_tables_and_rows_equal_reference(lm, backend, paged):
    kw = dict(batch_hints=(2, 4), prompt_len=PROMPT)
    if paged:
        kw.update(page_size=paged[0], kv_pages=paged[1])
    got = P.compile_lm(lm["params"], lm["cfg"], **kw)
    ref = jplan.compile_lm(lm["jraw"], lm["jcfg"], backend=backend,
                           verify=False, **kw)
    assert got.kind == ref.kind == "lm" and got.backend == "cuda"
    assert got.model == ref.model and got.batch_hints == ref.batch_hints
    ref_dense = {_map_backend(k, "cuda"): v
                 for k, v in ref.dense_table.items()}
    assert sorted(got.dense_table) == sorted(ref_dense)
    assert {_map_backend(k, "cuda"): v for k, v in ref.attn_table.items()} \
        == got.attn_table
    rows = lambda plan: [(lp.name, lp.op, lp.k, lp.cout)  # noqa: E731
                         for lp in plan.layers]
    assert rows(got) == rows(ref)
    if backend == "tpu":     # the target the cuda one routes as
        assert got.dense_table == ref_dense
        assert [(lp.name, lp.engine, lp.engine_source, lp.attn_engine,
                 lp.engines) for lp in got.layers] == [
            (lp.name, lp.engine, lp.engine_source, lp.attn_engine,
             lp.engines) for lp in ref.layers]
    else:                    # the CPU target's float engine
        assert set(ref.dense_table.values()) == {"f32dot"}
        assert set(got.dense_table.values()) == {"int8"}
    assert len(got.dense_table) == 5     # q, k/v, o, in/gate, out
    assert any(len(k) == 10 for k in got.attn_table) == bool(paged)


def test_compile_lm_accepts_prequantized_params(lm):
    pre = L.prequantize_params(lm["params"], lm["cfg"])
    a = P.compile_lm(lm["params"], lm["cfg"], prompt_len=PROMPT)
    b = P.compile_lm(pre, lm["cfg"], prompt_len=PROMPT)
    assert a.fingerprint() == b.fingerprint()
    for (pa, la), (pb, lb) in zip(_leaves(a.params), _leaves(b.params)):
        assert pa == pb and torch.equal(la, lb)


@pytest.mark.parametrize("kw,exc", [(dict(verify=True), None),
                                    (dict(page_size=16), ValueError),
                                    (dict(page_size=16, kv_pages=0),
                                     ValueError)])
def test_compile_lm_refusals(lm, kw, exc):
    """An incomplete paged geometry is refused; ``verify=True`` (the
    default, which raised before the prover was ported) compiles and
    returns a plan that proves clean."""
    if exc is None:
        from repro_torch.analysis.prover import verify_plan

        plan = P.compile_lm(lm["params"], lm["cfg"], **kw)
        assert plan.kind == "lm" and verify_plan(plan) == []
        return
    with pytest.raises(exc):
        P.compile_lm(lm["params"], lm["cfg"], **kw)


def test_compile_lm_autotune_times_the_signed_engines(lm, tmp_path,
                                                     monkeypatch):
    plan = P.compile_lm(lm["params"], lm["cfg"], prompt_len=PROMPT,
                        autotune=True)
    assert plan.autotune and all(k[0] == "signed" and k[-1] == "cpu"
                                 for k in plan.autotune)
    for lp in plan.layers:
        if lp.op == "dense":
            assert lp.engine_source == "autotuned"
            assert lp.engine in ("f32dot", "int8")
            key = ("signed", PROMPT, lp.k, lp.cout, 8, 1, "cpu")
            assert plan.autotune[key][0] == lp.engine
            assert set(plan.autotune[key][1]) == {"f32dot", "int8"}
    path = P.save_plan(plan, str(tmp_path / "lm"))
    ops.clear_plan_state()
    monkeypatch.setattr(ops, "_time_engine", lambda *a, **kw: (_ for _ in (
        )).throw(AssertionError("a reload measured")))
    back = P.load_plan(path, device="cpu")
    assert back.autotune == plan.autotune
    assert back.fingerprint() == plan.fingerprint()
    again = P.compile_lm(lm["params"], lm["cfg"], prompt_len=PROMPT,
                         autotune=True)
    assert again.dense_table == plan.dense_table


# ---------------------------------------------------------------------------
# plan files
# ---------------------------------------------------------------------------

def test_lm_plan_round_trip_and_reference_reads_it(lm, tmp_path):
    plan = P.compile_lm(lm["params"], lm["cfg"], prompt_len=PROMPT,
                        page_size=16, kv_pages=2)
    path = P.save_plan(plan, str(tmp_path / "lm"))
    meta = json.load(open(path))
    assert meta["kind"] == "lm" and meta["backend"] == "cuda"
    back = P.load_plan(path, device="cpu")
    assert back.fingerprint() == plan.fingerprint()
    assert back.dense_table == plan.dense_table
    assert back.attn_table == plan.attn_table
    got, want = list(_leaves(back.params)), list(_leaves(plan.params))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    ref = jplan.load_plan(path)
    assert ref.kind == "lm" and ref.fingerprint() == plan.fingerprint()
    for (p, a), (_, b) in zip(_leaves(ref.params), want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=p)


def test_reference_tpu_lm_plan_serves_the_reference_tokens(lm, tmp_path):
    ref = jplan.compile_lm(lm["jraw"], lm["jcfg"], backend="tpu",
                           prompt_len=PROMPT, verify=False)
    path = jplan.save_plan(ref, str(tmp_path / "ref"))
    want = japi.CompiledModel(ref, model=japi.build(lm["jcfg"])).serve(
        new_tokens=NEW, max_batch=4).predict(lm["prompts"])
    plan = convert.plan_from_reference(path, device="cpu")
    assert plan.backend == "cuda" and plan.kind == "lm"
    assert all(k[5] == "cuda" for k in plan.dense_table)
    assert all(k[7] == "cuda" for k in plan.attn_table)
    got = api.CompiledModel(plan, model=api.build(lm["cfg"])).serve(
        new_tokens=NEW, max_batch=4).predict(lm["prompts"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    cpu = jplan.compile_lm(lm["jraw"], lm["jcfg"], backend="cpu",
                           prompt_len=PROMPT, verify=False)
    with pytest.raises(P.PlanError, match="'cpu'"):
        convert.plan_from_reference(jplan.save_plan(cpu, str(tmp_path / "c")),
                                    device="cpu")


# ---------------------------------------------------------------------------
# the facade and the runners
# ---------------------------------------------------------------------------

def test_facade_lm_tokens_equal_the_reference_facade(lm, tmp_path):
    compiled = api.build(lm["cfg"], params=lm["params"]).compile(
        prompt_len=PROMPT, batch_hints=(4,), cache=str(tmp_path / "lm"))
    assert compiled.plan.kind == "lm" and not compiled.reloaded
    got = compiled.serve(new_tokens=NEW, max_batch=4).predict(lm["prompts"])
    want = japi.build(lm["jcfg"], params=lm["jraw"]).compile(
        target="cpu", prompt_len=PROMPT, batch_hints=(4,),
        verify=False).serve(new_tokens=NEW, max_batch=4).predict(
        lm["prompts"])
    for a, b in zip(got, want):
        assert a.shape == (NEW,)
        np.testing.assert_array_equal(a, np.asarray(b))
    # reload through the cache and through api.load: same tokens
    again = api.build(lm["cfg"], params=lm["params"]).compile(
        prompt_len=PROMPT, batch_hints=(4,), cache=str(tmp_path / "lm"))
    assert again.reloaded
    loaded = api.load(str(tmp_path / "lm"), spec=lm["cfg"], device="cpu")
    for c in (again, loaded):
        assert c.fingerprint() == compiled.fingerprint()
        for a, b in zip(c.serve(new_tokens=NEW, max_batch=4).predict(
                lm["prompts"]), got):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(P.PlanError, match="CNN plans"):
        compiled.forward(torch.zeros(1, 4))
    with pytest.raises(P.PlanError, match="CNN plans"):
        compiled.simulate("sot_mram")
    with pytest.raises(P.PlanError, match="ArchConfig"):
        api.load(str(tmp_path / "lm"), device="cpu").serve()


def test_runners_dispatch_through_the_plan_tables(lm, monkeypatch):
    """A plan whose dense verdicts say ``packed`` makes every projection
    of the bucket and continuous engines run ``packed`` (the tokens stay
    equal: every signed engine gives the same result), the paged decode
    step hits the plan's paged key, and the tables are uninstalled after
    each dispatch."""
    plan = P.compile_lm(lm["params"], lm["cfg"], prompt_len=PROMPT,
                        batch_hints=(4,), page_size=16, kv_pages=2)
    packed = dataclasses.replace(plan, dense_table={
        k: "packed" for k in plan.dense_table})
    seen, hits = [], []
    real = L.quant_dense_forward_signed_pre

    def spy(*a, engine="int8", **kw):
        seen.append(engine)
        return real(*a, engine=engine, **kw)

    class Recording(dict):
        def get(self, key, default=None):
            if key in self:
                hits.append(key)
            return super().get(key, default)

    monkeypatch.setattr(L, "quant_dense_forward_signed_pre", spy)
    monkeypatch.setattr(ops, "_PLAN_TABLE", Recording())
    cfg = lm["cfg"]
    want = api.CompiledModel(plan, model=api.build(cfg)).serve(
        new_tokens=NEW, max_batch=4).predict(lm["prompts"])
    assert set(seen) == {"int8"}
    seen.clear()
    got = api.CompiledModel(packed, model=api.build(cfg)).serve(
        new_tokens=NEW, max_batch=4).predict(lm["prompts"])
    assert set(seen) == {"packed"} and not ops._PLAN_TABLE
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the continuous engine over the plan: paged key hits, plan identity
    seen.clear()
    hits.clear()
    eng = ContinuousLMEngine(None, cfg, num_slots=2, page_size=16,
                             num_pages=8, max_seq=32, new_tokens=NEW,
                             model_plan=packed)
    plain = ContinuousLMEngine(plan.params, cfg, num_slots=2, page_size=16,
                               num_pages=8, max_seq=32, new_tokens=NEW)
    res = eng.serve(lm["prompts"])
    assert set(seen) == {"packed"}
    paged_key = next(k for k in plan.attn_table if len(k) == 10)
    assert paged_key in hits
    for a, b in zip(res, plain.serve(lm["prompts"])):
        np.testing.assert_array_equal(a.value, b.value)
    assert not ops._PLAN_TABLE


def test_cli_plan_cache_twice_reloads_and_repeats_the_tokens(capsys,
                                                            tmp_path):
    argv = ["--device", "cpu", "--quant", "w1a8", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "4", "--plan-cache",
            str(tmp_path / "lm")]
    serve.main(argv)
    first = capsys.readouterr().out
    serve.main(argv)
    second = capsys.readouterr().out
    assert "plan: compiled in" in first
    assert "plan: reloaded" in second
    assert "(requantization + autotune skipped)" in second

    def tokens(out):
        return [ln for ln in out.splitlines() if "sample[" in ln]

    assert tokens(first) and tokens(first) == tokens(second)
    assert not ops._PLAN_TABLE


@pytest.mark.parametrize("plan", [
    lambda M: M.scripted([("prefill", 0, "power_loss"),
                          ("decode", 1, "device_drop"),
                          ("staging", 2, "staging_corruption"),
                          ("decode", 3, "slow_dispatch")]),
    lambda M: M(4.0, seed=11)])
def test_facade_resilient_lm_counters_equal_the_reference(lm, tmp_path,
                                                         plan):
    prompts = lm["prompts"] * 2
    port = api.build(lm["cfg"], params=lm["params"]).compile(
        prompt_len=PROMPT, batch_hints=(4,)).serve(
        new_tokens=NEW, max_batch=4, resilience=ResilienceConfig(
            fault_plan=plan(FaultPlan), checkpoint_dir=str(tmp_path / "t"),
            epoch_steps=2, max_retries=50))
    ref = japi.build(lm["jcfg"], params=lm["jraw"]).compile(
        target="cpu", prompt_len=PROMPT, batch_hints=(4,),
        verify=False).serve(
        new_tokens=NEW, max_batch=4, resilience=JResilienceConfig(
            fault_plan=plan(JFaultPlan), checkpoint_dir=str(tmp_path / "j"),
            epoch_steps=2, max_retries=50))
    got, want = port.predict(prompts), ref.predict(prompts)
    assert {k: port.stats[k] for k in COUNTERS} == {
        k: ref.stats[k] for k in COUNTERS}
    assert port.stats["faults"] >= 1
    assert port.engine.runner.plan_fingerprint() == \
        port.compiled.fingerprint()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
