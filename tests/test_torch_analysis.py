"""The port's static verification (``repro_torch.analysis``: intervals,
the PV101-PV108 plan prover, repro-lint RL001-RL005, the CLI) held to the
reference's (``repro.analysis``), and the float-weight forms it needed
(``quant_dense_forward_signed`` behind serve-mode ``qdense``,
``quant_conv2d``).

* the interval domain equals the reference's on seeded random intervals;
* the port's golden plans (the reference CLI's set: svhn W1A4 at 40x40,
  AlexNet W1A8 at 112x112, the smoke SmolLM) prove clean at ``cuda`` and
  ``cpu``, and so do the reference's own golden plans after
  ``plan_from_reference``;
* every adversarial plan of ``tests/test_analysis.py`` has a port
  counterpart refused with the same rule ID; where the Hopper bound
  differs from the TPU one, both boundaries are stated, and each of the
  port's boundaries equals its kernel wrapper's own guard (through the
  pure predicates, and the CPU-side checks where the wrapper makes them);
* each lint rule fires and is suppressed on port-idiom snippets (RL004 on
  a synthetic ``.cu`` text), the tree lints clean, and RL004 proves all
  twelve ``launcher`` sites against ``csrc``;
* serve-mode ``qdense`` and ``quant_conv2d`` on float weights answer as
  the jitted reference does, with equal levels.
"""
import dataclasses
import json
import os
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.analysis import intervals as jiv  # noqa: E402
from repro.analysis import prover as jprover  # noqa: E402
from repro.configs import all_configs  # noqa: E402
from repro.configs.paper_cnn import ALEXNET_SPEC as J_ALEXNET  # noqa: E402
from repro.configs.paper_cnn import SVHN_SPEC as J_SVHN  # noqa: E402
from repro.core import and_accum as jaa  # noqa: E402
from repro.core import conv_lowering as jconv  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis import intervals as iv  # noqa: E402
from repro_torch.analysis import prover  # noqa: E402
from repro_torch.analysis.__main__ import (golden_lm_config,  # noqa: E402
                                           golden_lm_numpy, main)
from repro_torch.analysis.lint import (CSources, launcher_signatures,  # noqa: E402
                                       lint_paths, lint_source)
from repro_torch.analysis.prover import (PlanVerificationError,  # noqa: E402
                                         Violation, assert_plan_verified,
                                         verify_plan, verify_plan_file)
from repro_torch.configs.paper_cnn import ALEXNET_SPEC, SVHN_SPEC  # noqa: E402
from repro_torch.core import and_accum, conv_lowering, quant  # noqa: E402
from repro_torch.core.plan import (LayerPlan, ModelPlan, PlanError,  # noqa: E402
                                   compile_lm, compile_model, save_plan)
from repro_torch.kernels import attn_flash, bitgemm_mxu, ops  # noqa: E402
from repro_torch.kernels import conv_implicit, fused_qgemm  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5      # x max|out|, the LM tests' tolerance


@pytest.fixture(scope="module")
def svhn_plan():
    return compile_model(None, SVHN_SPEC, quant.W1A4, batch_hints=(1, 8),
                         img_hw=40, model="svhn")


@pytest.fixture(scope="module")
def alexnet_plan():
    return compile_model(None, ALEXNET_SPEC, quant.W1A8, batch_hints=(1, 8),
                         img_hw=112, model="alexnet")


@pytest.fixture(scope="module")
def lm_raw():
    return golden_lm_numpy(golden_lm_config())


@pytest.fixture(scope="module")
def lm_plan(lm_raw):
    cfg = golden_lm_config()
    return compile_lm(convert.lm_params_from_numpy(lm_raw, cfg, "cpu"), cfg,
                      batch_hints=(2,), prompt_len=8)


@pytest.fixture(scope="module")
def reference_golden(lm_raw, tmp_path_factory):
    """The reference CLI's golden plans, compiled by the reference for
    ``tpu`` (``plan_from_reference`` refuses ``cpu`` plans) from the same
    numpy draws, saved, and read back by the port."""
    tmp = tmp_path_factory.mktemp("reference_golden")
    plans = {}
    for name, spec, img, q in (("svhn", J_SVHN, 40, jquant.W1A4),
                               ("alexnet", J_ALEXNET, 112, jquant.W1A8)):
        plans[name] = jplan.compile_model(None, spec, q, backend="tpu",
                                          batch_hints=(1, 8), img_hw=img,
                                          model=name)
    jcfg = dataclasses.replace(
        all_configs()["smollm-360m"].smoke(
            n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
            vocab=64, head_dim=32),
        quant=dataclasses.replace(jquant.W1A8, engine="auto"))
    plans["lm"] = jplan.compile_lm(jax.tree.map(jnp.asarray, lm_raw), jcfg,
                                   backend="tpu", batch_hints=(2,),
                                   prompt_len=8)
    return {name: convert.plan_from_reference(
        jplan.save_plan(p, str(tmp / name)), device="cpu")
        for name, p in plans.items()}


def _conv_row(k, engine, a_bits=8, w_bits=8):
    """A synthetic quantized 1x1 conv row with consistent GEMM geometry
    (the reference test's)."""
    return LayerPlan(
        index=0, name="adv", op="conv", role="mid", fp=False, kh=1, kw=1,
        stride=1, padding="SAME", cin=k, cout=16, in_h=8, in_w=8, out_h=8,
        out_w=8, k=k, a_bits=a_bits, w_bits=w_bits, engine=engine,
        engine_source="override", engines=((1, engine), (8, engine)),
        cost=(1.0, 1.0, 1.0))


def _attn_row(head_dim, engine="flash"):
    return LayerPlan(
        index=0, name="adv_attn", op="attn", role="mid", fp=False, kh=0,
        kw=0, stride=1, padding="", cin=0, cout=0, in_h=0, in_w=0, out_h=0,
        out_w=0, k=head_dim, a_bits=8, w_bits=8, engine=engine,
        engine_source="override", engines=((1, engine), (8, engine)),
        cost=(1.0, 1.0, 1.0), attn_engine=engine)


def _rules(violations):
    return {v.rule for v in violations}


# ---------------------------------------------------------------------------
# intervals: the reference's domain
# ---------------------------------------------------------------------------

def _pair(rs):
    lo = int(rs.randint(-1 << 20, 1 << 20))
    return lo, lo + int(rs.randint(0, 1 << 20))


def test_intervals_equal_reference_on_seeded_intervals():
    rs = np.random.RandomState(0)
    assert (iv.FP32_MANTISSA, iv.INT32_MAX) == (jiv.FP32_MANTISSA,
                                                jiv.INT32_MAX)
    as_t = lambda x: (x.lo, x.hi)  # noqa: E731
    for _ in range(300):
        (a0, a1), (b0, b1) = _pair(rs), _pair(rs)
        a, b = iv.Interval(a0, a1), iv.Interval(b0, b1)
        ja, jb = jiv.Interval(a0, a1), jiv.Interval(b0, b1)
        n = int(rs.randint(-3, 5000))
        bound = int(rs.randint(1, 1 << 22))
        assert as_t(a + b) == as_t(ja + jb)
        assert as_t(a - b) == as_t(ja - jb)
        assert as_t(-a) == as_t(-ja)
        assert as_t(a * b) == as_t(ja * jb)
        assert as_t(a.scale(n)) == as_t(ja.scale(n))
        assert a.mag == ja.mag and a.within(bound) == ja.within(bound)
    for bits in range(1, 17):
        k = int(rs.randint(1, 1 << 16))
        assert as_t(iv.level_range(bits)) == as_t(jiv.level_range(bits))
        assert as_t(iv.centered_range(bits)) == as_t(
            jiv.centered_range(bits))
        assert as_t(iv.dot_range(iv.level_range(bits), iv.centered_range(
            bits), k)) == as_t(jiv.dot_range(jiv.level_range(bits),
                                             jiv.centered_range(bits), k))
    with pytest.raises(ValueError, match="empty interval"):
        iv.Interval(1, 0)


# ---------------------------------------------------------------------------
# golden plans prove clean
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", ["cuda", "cpu"])
@pytest.mark.parametrize("name", ["svhn", "alexnet", "lm"])
def test_golden_plans_verify_clean(name, target, request):
    plan = request.getfixturevalue(f"{name}_plan")
    assert plan.backend == "cuda"
    assert verify_plan(plan, target) == []


@pytest.mark.parametrize("name", ["svhn", "alexnet", "lm"])
def test_reference_golden_plans_verify_clean_after_conversion(
        name, reference_golden, request):
    plan = reference_golden[name]
    assert plan.backend == "cuda"
    assert verify_plan(plan) == []
    # the conversion keeps the reference's routing: the port's own compile
    # of the same model pins the same engines
    mine = request.getfixturevalue(f"{name}_plan")
    assert [(lp.name, lp.engines) for lp in plan.layers] == [
        (lp.name, lp.engines) for lp in mine.layers]


@pytest.mark.parametrize("name", ["svhn", "lm"])
def test_verify_plan_file_clean_on_saved_artifact(name, request, tmp_path):
    base = save_plan(request.getfixturevalue(f"{name}_plan"),
                     str(tmp_path / name))
    assert verify_plan_file(base) == []


# ---------------------------------------------------------------------------
# the reference's adversarial plans, on the port's plans: same rule IDs
# ---------------------------------------------------------------------------

def test_mantissa_overflow_bits_rejected_pv101(svhn_plan):
    """16x16-bit f32dot at K=180 blows the fp32 mantissa: PV101, and the
    feasibility re-check PV103 (the port's kernels take uint8 levels)."""
    bad = dataclasses.replace(
        svhn_plan, layers=(_conv_row(180, "f32dot", a_bits=16, w_bits=16),))
    violations = verify_plan(bad)
    assert {"PV101", "PV103"} <= _rules(violations)
    assert any("uint8" in v.message for v in violations)


def test_int32_accumulator_overflow_rejected_pv102(svhn_plan):
    bad = dataclasses.replace(
        svhn_plan, layers=(_conv_row(64, "int8", a_bits=20, w_bits=20),))
    assert "PV102" in _rules(verify_plan(bad))


def test_infeasible_engine_row_rejected_pv103(svhn_plan):
    """The reference's case pins the Pallas ``fused`` engine on a cpu plan;
    on the port ``fused`` is a CUDA kernel with a plain version, feasible
    on every target, so the counterpart pins ``implicit`` on a 1x1 conv
    (no patch to amplify)."""
    ok = verify_plan(dataclasses.replace(svhn_plan,
                                         layers=(_conv_row(64, "fused"),)),
                     "cpu")
    assert ok == []
    violations = verify_plan(
        dataclasses.replace(svhn_plan, layers=(_conv_row(64, "implicit"),)))
    assert any(v.rule == "PV103" and "implicit" in v.message
               for v in violations)


def test_missing_attn_table_row_rejected_pv104(lm_plan):
    violations = verify_plan(dataclasses.replace(lm_plan, attn_table={}))
    assert any(v.rule == "PV104" and "attn_table" in v.where
               for v in violations)


def test_orphan_dense_table_entry_rejected_pv104(lm_plan):
    table = dict(lm_plan.dense_table)
    table[("dense", 999, 999, 8, 1, "cuda")] = "planes"
    violations = verify_plan(dataclasses.replace(lm_plan,
                                                 dense_table=table))
    assert any(v.rule == "PV104" and "orphan" in v.message
               for v in violations)


def test_paged_lm_plan_verifies_clean_pv108(lm_raw):
    cfg = golden_lm_config()
    plan = compile_lm(convert.lm_params_from_numpy(lm_raw, cfg, "cpu"), cfg,
                      batch_hints=(1, 4), prompt_len=8, page_size=4,
                      kv_pages=8)
    assert verify_plan(plan) == []
    paged_keys = [k for k in plan.attn_table if len(k) == 10]
    assert paged_keys and all(k[8] == 4 and k[9] == 32 for k in paged_keys)
    assert set(plan.attn_table.values()) == {"full", "paged"}


def test_paged_nontiling_page_size_rejected_pv108(lm_plan):
    table = dict(lm_plan.attn_table)
    table[("attn", 1, 2, 32, True, 0, True, "cuda", 3, 32)] = "paged"
    violations = verify_plan(dataclasses.replace(lm_plan, attn_table=table))
    assert any(v.rule == "PV108" and "tile" in v.message
               for v in violations)


def test_paged_int32_index_overflow_rejected_pv108(lm_plan):
    table = dict(lm_plan.attn_table)
    big = 1 << 25                          # 2 * big * 2 * 32 = 2^32 > int32
    table[("attn", 1, 2, 32, True, 0, True, "cuda", 4, big)] = "paged"
    violations = verify_plan(dataclasses.replace(lm_plan, attn_table=table))
    assert any(v.rule == "PV108" and "int32" in v.message
               for v in violations)


def test_corrupted_cost_annotation_rejected_pv105(svhn_plan):
    row = dataclasses.replace(svhn_plan.layers[1], cost=(-1.0, 10.0, 10.0))
    bad = dataclasses.replace(
        svhn_plan, layers=(svhn_plan.layers[0], row) + svhn_plan.layers[2:])
    assert any(v.rule == "PV105" and "energy_pj=-1.0" in v.message
               for v in verify_plan(bad))


@pytest.mark.parametrize("change", [dict(version=99),
                                    dict(batch_hints=(1, 1))],
                         ids=["version_drift", "duplicate_batch_hints"])
def test_structure_drift_rejected_pv107(svhn_plan, change):
    assert "PV107" in _rules(verify_plan(dataclasses.replace(svhn_plan,
                                                             **change)))


def test_hand_edited_artifact_rejected_on_disk_pv106(svhn_plan, tmp_path):
    path = save_plan(svhn_plan, str(tmp_path / "edited"))
    with open(path) as f:
        meta = json.load(f)
    meta["zzz_hand_edit"] = True
    with open(path, "w") as f:
        json.dump(meta, f)
    assert "PV106" in _rules(verify_plan_file(path))


def test_assert_plan_verified_raises_plan_error(svhn_plan):
    bad = dataclasses.replace(
        svhn_plan, layers=(_conv_row(180, "f32dot", a_bits=16, w_bits=16),))
    with pytest.raises(PlanVerificationError) as ei:
        assert_plan_verified(bad)
    assert isinstance(ei.value, PlanError)  # existing handlers catch it
    assert "verify=False" in str(ei.value)
    assert all(isinstance(v, Violation) for v in ei.value.violations)


# ---------------------------------------------------------------------------
# the prover subsumes the runtime guards (same boundary, earlier)
# ---------------------------------------------------------------------------

def test_prover_subsumes_f32dot_guard(svhn_plan):
    """At 8x8 bits the f32dot bound flips between K=258 and K=259, as in
    the reference; the prover rejects exactly where ``bitgemm_f32dot``
    raises."""
    assert and_accum.f32dot_exact(258, 8, 8)
    assert not and_accum.f32dot_exact(259, 8, 8)
    for k in (258, 259):
        plan = dataclasses.replace(svhn_plan,
                                   layers=(_conv_row(k, "f32dot"),))
        assert ("PV101" in _rules(verify_plan(plan))) == (k == 259)
        jp = dataclasses.replace(jplan.compile_model(
            None, J_SVHN, jquant.W1A4, backend="cpu", img_hw=40,
            verify=False), layers=(jplan.LayerPlan(**dataclasses.asdict(
                _conv_row(k, "f32dot"))),))
        assert ("PV101" in _rules(jprover.verify_plan(jp))) == (k == 259)
    a = torch.ones((1, 259), dtype=torch.int32)
    w = torch.ones((259, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="f32dot engine inexact"):
        and_accum.bitgemm_f32dot(a, w, 8, 8)
    assert and_accum.bitgemm_f32dot(a[:, :258], w[:258], 8, 8).shape == (1, 4)


def test_prover_subsumes_flash_guard(svhn_plan):
    """``flash_levels_exact`` flips at head_dim 1024 (8/8 bits); the
    prover flags PV101 exactly there, before ``attn_flash_plain`` raises."""
    assert attn_flash.flash_levels_exact(1023, 8, 8)
    assert not attn_flash.flash_levels_exact(1024, 8, 8)
    for hd in (1023, 1024):
        plan = dataclasses.replace(svhn_plan, layers=(_attn_row(hd),))
        assert ("PV101" in _rules(verify_plan(plan))) == (hd == 1024)
    q = torch.zeros((1, 4, 1, 1024))
    with pytest.raises(ValueError, match="head_dim"):
        attn_flash.attn_flash_plain(q, q, q)


def test_implicit_bound_is_int32_on_the_port_pv102(svhn_plan):
    """Where the bounds differ: at W8A8 ``implicit`` the reference's
    off-TPU engine sums 4-bit group products in float32 and refuses at
    PV101 from K = 74566 (15*15*K >= 2^24); the port's accumulates u8
    products in int32 and refuses at PV102 from K = 33026
    (255*255*K >= 2^31), with no float obligation at all."""
    jbase = jplan.compile_model(None, J_SVHN, jquant.W1A4, backend="cpu",
                                img_hw=40, verify=False)
    for k in (74565, 74566):
        jp = dataclasses.replace(jbase, layers=(jplan.LayerPlan(
            **dataclasses.asdict(_conv_row(k, "implicit"))),))
        assert ("PV101" in _rules(jprover.verify_plan(jp))) == (k == 74566)
    assert and_accum.int32_exact(33025, 8, 8)
    assert not and_accum.int32_exact(33026, 8, 8)
    for k in (33025, 33026, 80000):
        rules = _rules(verify_plan(dataclasses.replace(
            svhn_plan, layers=(_conv_row(k, "implicit"),))))
        assert "PV101" not in rules
        assert ("PV102" in rules) == (k > 33025)


# ---------------------------------------------------------------------------
# each of the port's boundaries is its kernel wrapper's own guard
# ---------------------------------------------------------------------------

def _one_row_cnn(row):
    return ModelPlan(kind="cnn", model="bounds", backend="cuda",
                     quant=quant.W1A8, batch_hints=(1,), layers=(row,))


def _gemm_row(k, engine, a_bits, w_bits):
    return dataclasses.replace(_conv_row(k, engine, a_bits, w_bits),
                               engines=((1, engine),))


def _implicit_row(h, w, cin, cout):
    return LayerPlan(
        index=0, name="deep", op="conv", role="mid", fp=False, kh=3, kw=3,
        stride=1, padding="SAME", cin=cin, cout=cout, in_h=h, in_w=w,
        out_h=h, out_w=w, k=9 * cin, a_bits=8, w_bits=1, engine="implicit",
        engine_source="override", engines=((1, "implicit"),),
        cost=(1.0, 1.0, 1.0))


def _one_row_attn(attn, engine):
    row = dataclasses.replace(_attn_row(attn.head_dim, engine),
                              engines=((1, engine),))
    return ModelPlan(kind="lm", model="bounds", backend="cuda",
                     quant=quant.W1A8, batch_hints=(1,), layers=(row,),
                     attn_table={ops.attn_plan_key(attn, "cuda"): engine})


def smem_boundary(h=4, cin=64, cout=64):
    """The widest image row whose 3x3 implicit block fits SMEM_LIMIT, and
    the next: the shared-memory boundary of ``conv_implicit``."""
    for w in range(16, 4096):
        lay = conv_implicit.smem_layout(h, w, cin, 3, 3, 1, "SAME", 1, cout)
        if lay.smem_bytes > conv_implicit.SMEM_LIMIT:
            return w - 1, w
    raise AssertionError("no boundary below 4096")


def test_fused_and_int8_bounds_are_the_wrappers_guards():
    """fused_qgemm W8A8: K = 33025 proven, 33026 refused, exactly where
    ``int32_exact`` and the wrapper's check flip; int8_matmul: K = 131071
    proven, 131072 refused (``int8_exact``).  On the CPU the wrappers make
    the same check before their plain versions."""
    for k, good in ((33025, True), (33026, False)):
        rules = _rules(verify_plan(_one_row_cnn(_gemm_row(k, "fused", 8, 8))))
        assert (not rules) == good == and_accum.int32_exact(k, 8, 8)
        a = torch.full((1, k), 255, dtype=torch.uint8)
        w = torch.full((k, 8), 255, dtype=torch.uint8)
        if good:
            out = fused_qgemm.fused_qgemm(a, w, 1.0, 0.0, a_bits=8, w_bits=8,
                                          a_is_levels=True)
            assert float(out[0, 0]) == pytest.approx(255 * 255 * k / 255)
        else:
            assert "PV102" in rules
            with pytest.raises(ValueError, match="overflow"):
                fused_qgemm.fused_qgemm(a, w, 1.0, 0.0, a_bits=8, w_bits=8,
                                        a_is_levels=True)
    for k, good in ((131071, True), (131072, False)):
        rules = _rules(verify_plan(_one_row_cnn(_gemm_row(k, "int8", 1, 1))))
        assert (not rules) == good == bitgemm_mxu.int8_exact(k)
        assert and_accum.int32_exact(k, 1, 1)   # only the s8 bound binds
        a = torch.ones((1, k), dtype=torch.int8)
        if good:
            assert int(bitgemm_mxu.int8_matmul(a, a.T.contiguous())) == k
        else:
            assert "PV102" in rules
            with pytest.raises(ValueError, match="overflow"):
                bitgemm_mxu.int8_matmul(a, a.T.contiguous())


def test_implicit_shared_memory_bound_is_smem_layout():
    """Two deep-K (K = 576) conv geometries on either side of the implicit
    block's shared-memory limit: proven and refused (PV103) exactly where
    ``smem_layout`` crosses ``SMEM_LIMIT`` (232448 B), the check the
    wrapper makes before a launch."""
    w_in, w_out = smem_boundary()
    for w, good in ((w_in, True), (w_out, False)):
        need = conv_implicit.smem_layout(4, w, 64, 3, 3, 1, "SAME", 1,
                                         64).smem_bytes
        assert (need <= conv_implicit.SMEM_LIMIT) == good
        violations = verify_plan(_one_row_cnn(_implicit_row(4, w, 64, 64)))
        assert (violations == []) == good
        if not good:
            assert _rules(violations) == {"PV103"}
            assert str(need) in violations[0].message


def test_attention_bounds_are_the_kernels_head_dims_and_smem():
    """attn_flash: head_dim 128 proven, 112 refused (``KERNEL_HEAD_DIMS``,
    PV103).  attn_paged: head_dim 128 proven, 256 refused by the block's
    shared memory (``paged_smem_bytes`` > ``SMEM_LIMIT``, PV108); the
    reference's bound there is an 8 MiB VMEM budget, which proves 256."""
    for hd, good in ((128, True), (112, False)):
        attn = ops.AttnShape(seq_q=2048, seq_kv=2048, heads=16, head_dim=hd,
                             quantized=True)
        rules = _rules(verify_plan(_one_row_attn(attn, "flash")))
        assert (not rules) == good == (hd in attn_flash.KERNEL_HEAD_DIMS)
        assert good or rules == {"PV103"}
    for hd, good in ((128, True), (256, False)):
        attn = ops.AttnShape(seq_q=1, seq_kv=16 * 18, heads=16, head_dim=hd,
                             quantized=True, page_size=16)
        rows = attn_flash.paged_heads_per_block(attn.heads, 1)
        fits = (attn_flash.paged_smem_bytes(rows, hd)
                <= attn_flash.SMEM_LIMIT)
        rules = _rules(verify_plan(_one_row_attn(attn, "paged")))
        assert (not rules) == good == fits
        assert good or "PV108" in rules
        jattn = jops.AttnShape(seq_q=1, seq_kv=16 * 18, heads=16,
                               head_dim=hd, quantized=True, page_size=16)
        assert jops.paged_attn_bounds(jattn) == (True, "")


# ---------------------------------------------------------------------------
# escape hatch + compile wiring
# ---------------------------------------------------------------------------

def test_compile_model_verify_escape_hatch(monkeypatch):
    """verify=True (default) routes through assert_plan_verified and
    surfaces prover rejections as PlanVerificationError; verify=False
    bypasses the prover entirely."""
    boom = [Violation("PV999", "test", "injected failure")]
    monkeypatch.setattr(prover, "verify_plan", lambda plan, target=None: boom)
    with pytest.raises(PlanVerificationError, match="PV999"):
        compile_model(None, SVHN_SPEC, quant.W1A4, batch_hints=(1,),
                      img_hw=40, model="svhn")
    plan = compile_model(None, SVHN_SPEC, quant.W1A4, batch_hints=(1,),
                         img_hw=40, model="svhn", verify=False)
    assert plan.layers


def test_compile_lm_verify_escape_hatch(monkeypatch, lm_raw):
    cfg = golden_lm_config()
    params = convert.lm_params_from_numpy(lm_raw, cfg, "cpu")
    boom = [Violation("PV999", "test", "injected failure")]
    monkeypatch.setattr(prover, "verify_plan", lambda plan, target=None: boom)
    with pytest.raises(PlanVerificationError, match="PV999"):
        compile_lm(params, cfg, batch_hints=(2,), prompt_len=8)
    assert compile_lm(params, cfg, batch_hints=(2,), prompt_len=8,
                      verify=False).kind == "lm"


# ---------------------------------------------------------------------------
# repro-lint rules on port-idiom sources
# ---------------------------------------------------------------------------

def _lint(src, rel, **kw):
    return lint_source(textwrap.dedent(src), rel, **kw)


def _lint_rules(src, rel, **kw):
    return {v.rule for v in _lint(src, rel, **kw)}


def test_rl001_wall_clock_in_resilience_only():
    src = """\
    import time
    def now():
        return time.time()
    """
    assert _lint_rules(src, "src/repro_torch/resilience/faults.py") \
        == {"RL001"}
    assert _lint_rules(src, "src/repro_torch/launch/serve.py") == set()


def test_rl001_unseeded_rngs():
    rel = "src/repro_torch/fleet/traces.py"
    assert _lint_rules("import numpy as np\nx = np.random.rand(3)\n",
                       rel) == {"RL001"}
    assert _lint_rules("import numpy as np\nr = np.random.RandomState()\n",
                       rel) == {"RL001"}
    assert _lint_rules("import numpy as np\nr = np.random.RandomState(7)\n",
                       rel) == set()
    for draw in ("torch.randn(3)", "torch.rand(2, 2)", "torch.randint(0, 9, (4,))",
                 "torch.randperm(5)", "torch.normal(0.0, 1.0, (3,))",
                 "torch.bernoulli(p)", "torch.multinomial(p, 2)"):
        assert _lint_rules(f"import torch\nx = {draw}\n", rel) == {"RL001"}
    seeded = "import torch\ng = torch.Generator().manual_seed(0)\n" \
             "x = torch.randn(3, generator=g)\n"
    assert _lint_rules(seeded, rel) == set()


def test_rl002_host_syncs_scoped_to_the_port():
    for expr in ("float(torch.max(x))", "int(torch.argmax(x))",
                 "bool(torch.any(x))", "x.item()", "x.cpu()",
                 "np.asarray(torch.ones(3))"):
        src = f"import numpy as np\nimport torch\ndef f(x):\n    return {expr}\n"
        assert _lint_rules(src, "src/repro_torch/kernels/k.py") == {"RL002"}
        assert _lint_rules(src, "tests/test_k.py") == set()   # out of scope
    assert _lint_rules("def f(x):\n    return float(x)\n",
                       "src/repro_torch/kernels/k.py") == set()


def test_rl002_inline_suppression():
    src = """\
    import torch
    def f(x):
        return float(torch.max(x))  # repro-lint: disable=RL002 — host helper
    """
    assert _lint_rules(src, "src/repro_torch/kernels/k.py") == set()


def test_rl003_broad_except_swallow():
    bad = "try:\n    work()\nexcept Exception:\n    pass\n"
    assert _lint_rules(bad, "chip_smoke.py") == {"RL003"}
    reraised = "try:\n    work()\nexcept Exception:\n    cleanup()\n    raise\n"
    assert _lint_rules(reraised, "chip_smoke.py") == set()
    narrow = bad.replace("Exception", "ValueError")
    assert _lint_rules(narrow, "chip_smoke.py") == set()
    pragma = bad.replace("except Exception:",
                         "except BaseException as e:  # noqa: BLE001  "
                         "repro-lint: disable=RL003 — recorded")
    assert _lint_rules(pragma, "src/repro_torch/train/x.py") == set()
    whole = "# repro-lint: disable-file=RL003 — scratch script\n" + bad
    assert _lint_rules(whole, "chip_smoke.py") == set()


_CU = """\
extern "C" int int8_matmul_plan(int M, int N, int K, int* plan) { return 0; }
extern "C" int int8_matmul_launch(const void* a, const void* b, void* out,
                                  int M, int N, int K, void* stream) {
  return 0;
}
extern "C" long long int8_matmul_scratch_bytes(long long n) { return n; }
"""

_LAUNCH = """\
import ctypes
from . import _lib
NAME = "int8_matmul"
def go():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _lib.launcher(NAME, ARGTYPES)
"""


@pytest.mark.parametrize("argtypes,message", [
    ("[p, p, p, i, i, i, p]", None),
    ("[p] * 3 + [i] * 3 + [p]", None),
    ("3 * [p] + [i, i, i] + [ctypes.c_void_p]", None),
    ("[p] * 3 + [i] * 2 + [p]", "6 parameter(s), its C signature takes 7"),
    ("[p, p, p, i, i, ctypes.c_float, p]", "parameter 5 is 'int' in C"),
    ("[p, p, p, i, i, ctypes.c_longlong, p]", "parameter 5 is 'int' in C"),
    ("make_argtypes()", "not statically verifiable"),
    ("[p] * n + [i]", "not statically verifiable"),
    ("[q] * 7", "'q' is not bound"),
], ids=["literal", "sum_of_products", "int_times_list", "arity", "float",
        "long_long", "call", "computed_count", "unbound"])
def test_rl004_launcher_against_synthetic_cu(argtypes, message):
    csrc = CSources(ROOT, texts={"int8_matmul": _CU})
    src = _LAUNCH.replace("ARGTYPES", argtypes)
    violations = _lint(src, "src/repro_torch/kernels/k.py", csrc=csrc)
    if message is None:
        assert violations == []
        return
    assert [v.rule for v in violations] == ["RL004"]
    assert message in violations[0].message
    # out of src/ the rule does not apply
    assert _lint(src, "tests/k.py", csrc=csrc) == []


@pytest.mark.parametrize("call,message", [
    ('_lib.launcher(NAME, [i, i, i, ctypes.POINTER(ctypes.c_int)], "plan")',
     None),
    ('_lib.launcher(NAME, [ll], "scratch_bytes", ll)', None),
    ('_lib.launcher(NAME, [ll], "scratch_bytes")',
     "returns 'long long' in C but restype is 'int'"),
    ('_lib.launcher(NAME, [p], "free")', 'has no extern "C" int8_matmul_free'),
    ('_lib.launcher("no_such_kernel", [p])', "not in _lib.KERNELS"),
    ('_lib.launcher(NAME, [p], suffix)', "suffix is not a string constant"),
], ids=["plan", "restype", "restype_mismatch", "no_function", "no_kernel",
        "computed_suffix"])
def test_rl004_suffix_restype_and_kernel(call, message):
    csrc = CSources(ROOT, texts={"int8_matmul": _CU})
    src = ("import ctypes\nfrom . import _lib\nNAME = \"int8_matmul\"\n"
           "def go(suffix):\n    p, i = ctypes.c_void_p, ctypes.c_int\n"
           f"    ll = ctypes.c_longlong\n    return {call}\n")
    violations = _lint(src, "src/repro_torch/kernels/k.py", csrc=csrc)
    if message is None:
        assert violations == []
    else:
        assert [v.rule for v in violations] == ["RL004"]
        assert message in violations[0].message


def test_rl004_a_name_bound_twice_is_unverifiable():
    csrc = CSources(ROOT, texts={"int8_matmul": _CU})
    src = _LAUNCH.replace("ARGTYPES", "[p, p, p, i, i, i, p]").replace(
        "    p, i = ctypes.c_void_p, ctypes.c_int\n",
        "    p, i = ctypes.c_void_p, ctypes.c_int\n    p = ctypes.c_int\n")
    violations = _lint(src, "src/repro_torch/kernels/k.py", csrc=csrc)
    assert [v.rule for v in violations] == ["RL004"]
    assert "not bound by one simple assignment" in violations[0].message


def test_rl005_foreign_private_mutation():
    src = """\
    def drain(engine):
        engine._pending = []
        engine._queue.append(1)
    """
    assert [v.rule for v in _lint(src, "src/repro_torch/launch/engine.py")] \
        == ["RL005", "RL005"]
    assert [v.rule for v in _lint(
        src, "src/repro_torch/resilience/engine.py")] == ["RL005", "RL005"]
    assert _lint(src, "src/repro_torch/launch/other.py") == []
    owner = """\
    class Engine:
        def drain(self):
            self._pending = []
    """
    assert _lint(owner, "src/repro_torch/launch/engine.py") == []


def test_lint_syntax_error_reports_rl000():
    violations = lint_source("def broken(:\n", "src/repro_torch/x.py")
    assert [v.rule for v in violations] == ["RL000"]


def test_the_tree_lints_clean_and_every_launcher_is_proven():
    paths = [os.path.join(ROOT, "src", "repro_torch"),
             os.path.join(ROOT, "chip_smoke.py")]
    assert [str(v) for v in lint_paths(paths, root=ROOT)] == []
    sites = launcher_signatures([paths[0]], root=ROOT)
    assert sorted(s[2] for s in sites) == sorted([
        "attn_flash_launch", "attn_flash_scratch_bytes", "attn_paged_plan",
        "attn_paged_launch", "bitgemm_packed_plan", "bitgemm_packed_launch",
        "int8_matmul_plan", "int8_matmul_launch", "conv_implicit_launch",
        "fused_qgemm_plan", "fused_qgemm_launch", "quantize_pack_launch",
        "norm_act_fit", "norm_act_launch"])
    assert len(sites) == 14


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_check_plan_ok_reject_and_usage(svhn_plan, tmp_path, capsys):
    path = save_plan(svhn_plan, str(tmp_path / "cli"))
    assert main(["check-plan", path]) == 0
    assert main(["check-plan", path, "--target", "cpu"]) == 0
    with open(path) as f:
        meta = json.load(f)
    meta["layers"][6]["engine"] = "implicit"     # svhn's 1x1 conv6
    meta["layers"][6]["engines"] = [[1, "implicit"], [8, "implicit"]]
    with open(path, "w") as f:
        json.dump(meta, f)
    assert main(["check-plan", path]) == 1
    out = capsys.readouterr().out
    assert "PV103" in out and "check-plan " + path + ": 2 violation(s)" \
        in out                            # one for each batch hint
    assert main(["check-plan"]) == 2  # no plans given


def test_cli_check_plan_golden(capsys):
    assert main(["check-plan", "--golden"]) == 0
    out = capsys.readouterr().out
    for name in ("svhn", "alexnet", "lm-smoke"):
        assert f"check-plan {name}: OK" in out


def test_cli_lint_exit_codes(tmp_path, capsys):
    assert main(["lint", "--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ("RL001", "RL002", "RL003", "RL004", "RL005"):
        assert rule in out
    bad = tmp_path / "swallow.py"
    bad.write_text("try:\n    work()\nexcept Exception:\n    pass\n")
    assert main(["lint", str(bad)]) == 1
    assert "RL003" in capsys.readouterr().out
    good = tmp_path / "fine.py"
    good.write_text("x = 1\n")
    assert main(["lint", str(good)]) == 0


# ---------------------------------------------------------------------------
# the float-weight forms: serve-mode qdense, quant_conv2d
# ---------------------------------------------------------------------------

def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


@pytest.mark.parametrize("mode", ["tensor", "row"])
@pytest.mark.parametrize("engine", list(and_accum.SIGNED_ENGINES))
def test_serve_qdense_on_float_weights_equals_reference(engine, mode):
    rs = np.random.RandomState(11)
    x = rs.randn(2, 5, 64).astype(np.float32)
    w = (rs.randn(64, 48) / 8).astype(np.float32)
    jq = dataclasses.replace(jquant.W1A8, engine=engine, act_scale_mode=mode)
    q = dataclasses.replace(quant.W1A8, engine=engine, act_scale_mode=mode)
    # equal levels: the weight's, and the activations' at this scale mode
    jw = jquant.weight_levels(jnp.asarray(w), q.w_bits)
    tw = quant.weight_levels(torch.from_numpy(w), q.w_bits)
    np.testing.assert_array_equal(np.asarray(jw[0]), tw[0].numpy())
    jfn = (jquant.activation_levels_signed_row if mode == "row"
           else jquant.activation_levels_signed)
    tfn = (quant.activation_levels_signed_row if mode == "row"
           else quant.activation_levels_signed)
    x2 = x.reshape(-1, 64)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda a: jfn(a, 8)[0])(x2)),
        tfn(torch.from_numpy(x2), 8)[0].numpy())
    ref = jax.jit(lambda a, b: JL.qdense(a, b, jq, mode="serve"))(x, w)
    got = L.qdense(torch.from_numpy(x), torch.from_numpy(w), q, mode="serve")
    _close(got, ref)
    # the same as serving the prequantized weight, bit for bit
    pre = {"q": tw[0].to(torch.int8), "s": tw[1].float(), "z": tw[2].float()}
    assert torch.equal(got, L.qdense(torch.from_numpy(x), pre, q,
                                     mode="serve"))


def test_float_in_dense_forms_equal_reference():
    rs = np.random.RandomState(12)
    a = rs.uniform(0, 1, (3, 7, 96)).astype(np.float32)
    w = (rs.randn(96, 40) / 10).astype(np.float32)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    for a_bits, w_bits in ((4, 1), (8, 2), (8, 8)):
        for engine in ("int8", "planes", "f32dot"):
            if engine == "f32dot" and not and_accum.f32dot_exact(96, a_bits,
                                                                 w_bits):
                continue
            ref = jax.jit(lambda x, y: jaa.quant_dense_forward(
                x, y, a_bits, w_bits, engine=engine))(a, w)
            _close(and_accum.quant_dense_forward(ta, tw, a_bits, w_bits,
                                                 engine=engine), ref)
        _close(and_accum.reference_float(ta, tw, a_bits, w_bits),
               jax.jit(lambda x, y: jaa.reference_float(
                   x, y, a_bits, w_bits))(a, w))
    # signed, levels past int8 (w_bits = 8): the reference's unsigned form
    x = rs.randn(6, 96).astype(np.float32)
    ref = jax.jit(lambda x, y: jaa.quant_dense_forward_signed(
        x, y, 8, 8, engine="int8"))(x, w)
    _close(and_accum.quant_dense_forward_signed(torch.from_numpy(x), tw, 8,
                                                8, engine="int8"), ref)


@pytest.mark.parametrize("engine", ["int8", "f32dot", "planes", "fused",
                                    None])
def test_quant_conv2d_on_float_weights_equals_reference(engine):
    rs = np.random.RandomState(13)
    x = rs.uniform(0, 1, (2, 9, 9, 6)).astype(np.float32)
    w = (rs.randn(3, 3, 6, 16) / 7).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_array_equal(
        np.asarray(jconv.im2col(jnp.asarray(x), 3, 3, 2, "SAME")),
        conv_lowering.im2col(tx, 3, 3, 2, "SAME").numpy())
    for stride, padding in ((1, "SAME"), (2, "VALID")):
        ref = jconv.quant_conv2d(jnp.asarray(x), jnp.asarray(w),
                                 stride=stride, padding=padding, a_bits=4,
                                 w_bits=1, engine=engine or "int8")
        got = conv_lowering.quant_conv2d(tx, tw, stride=stride,
                                         padding=padding, a_bits=4,
                                         w_bits=1, engine=engine)
        _close(got, ref)
