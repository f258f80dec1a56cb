"""Power-intermittency resilience in the port (``repro_torch.resilience``,
``repro_torch.train.checkpoint``) held to the reference's contracts
(``tests/test_resilience.py``, ``tests/test_intermittent.py``).

* ``FaultPlan`` event logs (mtbf, scripted, timeline), their JSON, and
  ``DegradePolicy`` decisions equal the reference's exactly;
* ``Checkpointer``: atomic commit and GC, stale tmp sweep, prefix purge,
  async round trip and write failures — plus what torch adds: a tensor
  mutated in place right after an async save reads back its pre-mutation
  values, and a bfloat16 cache round-trips bit for bit;
* every faulted and resumed run (CNN dispatch, LM prefill, mid-decode,
  staging) is bit-identical to the fault-free run; with the same fault
  plan, requests and no degrade, the engine's counters equal the
  reference engine's;
* recovery (retries, dead letters, deadlines, backoff) and degradation
  (fault pressure, energy budget, recovery) as in the reference.

Geometry: svhn(8) at 16x16 (the reference's resilience tests' CNN) and
the smollm-360m smoke config with the full model's GQA group of 3, W1A8,
float32 (bfloat16 where stated); the kernels' plain versions (CPU).
"""
import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.quant import PAPER_CONFIGS as JPAPER  # noqa: E402
from repro.models.layers import prequantize_params as jprequant  # noqa: E402
from repro.resilience import DegradePolicy as JDegradePolicy  # noqa: E402
from repro.resilience import EpochLMRunner as JEpochLMRunner  # noqa: E402
from repro.resilience import FaultPlan as JFaultPlan  # noqa: E402
from repro.resilience import (  # noqa: E402
    ResilientServeEngine as JResilientServeEngine)
from repro_torch import api, convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import plan as P  # noqa: E402
from repro_torch.core.quant import PAPER_CONFIGS, W1A1, W1A8  # noqa: E402
from repro_torch.launch.engine import (CNNRunner, LMRunner,  # noqa: E402
                                       ServeEngine)
from repro_torch.models import cnn  # noqa: E402
from repro_torch.resilience import (DegradePolicy, DeviceDrop,  # noqa: E402
                                    EpochLMRunner, FaultEvent, FaultPlan,
                                    PowerLoss, ResilienceConfig,
                                    ResilientServeEngine)
from repro_torch.train import checkpoint as C  # noqa: E402

GEOM = dict(n_layers=2, d_model=64, n_heads=3, n_kv_heads=1, d_ff=128,
            vocab=64, head_dim=32)
NEW_TOKENS = 7          # 6 decode steps; epoch_steps=2 -> schedule (2, 2, 2)
# counters that are functions of the fault schedule and the submit order
# (commit_s is a wall time; energy_pj comes from the target's constants)
COUNTERS = ("faults", "power_losses", "device_drops", "slow_dispatches",
            "staging_retries", "retries", "dead_lettered", "degrades",
            "recoveries", "prefills", "resumes", "epochs", "commits",
            "executed_steps", "useful_steps", "wasted_steps", "dispatches",
            "requests", "padded_rows")


# ---------------------------------------------------------------------------
# FaultPlan and DegradePolicy: the reference's decisions, exactly
# ---------------------------------------------------------------------------

POLLS = [("staging", 0.25), ("prefill", 1.0), ("decode", 2.0),
         ("decode", 2.0), ("dispatch", 1.0), ("decode", 0.5)] * 12


def _log(plan):
    for site, dt in POLLS:
        plan.poll(site, dt=dt)
    return [(e.kind, e.site, e.t, e.offset, e.seq) for e in plan.log]


def _both(ctor, *args, **kw):
    return (getattr(FaultPlan, ctor)(*args, **kw) if ctor else
            FaultPlan(*args, **kw),
            getattr(JFaultPlan, ctor)(*args, **kw) if ctor else
            JFaultPlan(*args, **kw))


@pytest.mark.parametrize("case", [
    (None, (3.0,), dict(seed=5)),
    (None, (0.7,), dict(seed=1)),
    (None, (2.0,), dict(seed=3, weights={"power_loss": 1.0,
                                         "slow_dispatch": 2.0})),
    ("scripted", ([("decode", 1, "power_loss"), ("staging", 0,
                                                  "staging_corruption"),
                   ("dispatch", 2, "device_drop")],), {}),
    ("timeline", ([(1.5, "power_loss"), (9.0, "power_loss"),
                   (30.0, "power_loss")],), {}),
    (None, (None,), {})])
def test_fault_plan_event_log_and_json_equal_the_reference(case, tmp_path):
    ctor, args, kw = case
    port, ref = _both(ctor, *args, **kw)
    assert port.to_json() == ref.to_json()
    assert _log(port) == _log(ref)
    # construction spec round trip: a reloaded plan replays the schedule
    again = FaultPlan.from_json(json.loads(json.dumps(port.to_json())))
    assert _log(again) == _log(FaultPlan.from_json(ref.to_json()))
    path = str(tmp_path / "plan.json")
    port.save(path)
    assert json.load(open(path)) == ref.to_json()
    assert _log(FaultPlan.load(path)) == _log(JFaultPlan.load(path))


def test_fault_plan_validation():
    with pytest.raises(ValueError):
        FaultPlan(0.0)
    with pytest.raises(ValueError):
        FaultPlan(1.0, weights={"meteor_strike": 1.0})
    with pytest.raises(ValueError):
        FaultPlan.scripted([("nowhere", 0, "power_loss")])
    with pytest.raises(ValueError):
        FaultPlan.scripted([("staging", 0, "device_drop")])
    with pytest.raises(ValueError):
        FaultPlan.timeline([(1.0, "staging_corruption")])
    with pytest.raises(ValueError):
        FaultPlan.timeline([(2.0, "power_loss"), (1.0, "power_loss")])
    with pytest.raises(ValueError, match="version"):
        FaultPlan.from_json({"version": 99})
    assert FaultPlan(None).poll("decode") is None


def test_fault_exception_types():
    with pytest.raises(PowerLoss):
        FaultPlan.raise_for(FaultEvent("power_loss", "decode", 1.0, 0.5, 0))
    with pytest.raises(DeviceDrop):
        FaultPlan.raise_for(FaultEvent("device_drop", "decode", 1.0, 0.5, 0))
    FaultPlan.raise_for(FaultEvent("slow_dispatch", "decode", 1.0, 0.5, 0))


def test_degrade_policy_decisions_equal_the_reference():
    rs = np.random.RandomState(4)
    seq = [("fault" if rs.uniform() < 0.3 else "dispatch",
            float(rs.uniform(0, 50))) for _ in range(200)]
    for kw in (dict(fault_window=4, fault_threshold=2),
               dict(energy_budget_pj=400.0, recover_after=3),
               dict(fault_window=8, fault_threshold=3, recover_after=2,
                    energy_budget_pj=1000.0)):
        port, ref = DegradePolicy(**kw), JDegradePolicy(**kw)
        for what, e in seq:
            for p in (port, ref):
                p.record_fault() if what == "fault" else p.record_dispatch(e)
            assert (port.should_degrade(), port.should_recover(),
                    port.fault_pressure(), port.clean_streak(),
                    port.spent_pj) == (
                ref.should_degrade(), ref.should_recover(),
                ref.fault_pressure(), ref.clean_streak(), ref.spent_pj)
            if port.should_degrade():
                port.reset()
                ref.reset()
    for bad in (dict(fault_window=0), dict(fault_threshold=0),
                dict(energy_budget_pj=-1.0), dict(recover_after=0)):
        with pytest.raises(ValueError):
            DegradePolicy(**bad)


# ---------------------------------------------------------------------------
# Checkpointer
# ---------------------------------------------------------------------------

def test_checkpointer_atomic_and_gc(tmp_path):
    ck = C.Checkpointer(str(tmp_path), keep=2, async_save=False)
    state = dict(w=torch.arange(6.0).reshape(2, 3), step=torch.tensor(3))
    for s in (1, 2, 3, 4):
        ck.save(s, state)
    names = sorted(os.listdir(tmp_path))
    assert len([n for n in names if n.startswith("ckpt_")]) == 2
    step, restored = ck.restore(state)
    assert step == 4
    assert torch.equal(restored["w"], state["w"])
    assert restored["step"].dtype == torch.int64
    assert not [n for n in names if n.startswith(".tmp_")]
    assert ck.manifest(4)["step"] == 4


def test_checkpointer_init_sweeps_stale_tmp_dirs(tmp_path):
    ck = C.Checkpointer(str(tmp_path), keep=2, async_save=False)
    ck.save(1, dict(w=torch.ones(2)))
    stale = tmp_path / ".tmp_killed_mid_write"
    stale.mkdir()
    (stale / "arrays.npz").write_bytes(b"partial")
    ck2 = C.Checkpointer(str(tmp_path), keep=2, async_save=False)
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp_")]
    assert ck2.latest_step() == 1


def test_checkpointer_purge_is_prefix_matching(tmp_path):
    ck = C.Checkpointer(str(tmp_path), keep=5, async_save=False)
    state = dict(w=torch.ones(2))
    ck.save(1, state, tag="decaaaa")
    ck.save(2, state, tag="decbbbb")
    ck.save(3, state, tag="ckpt")
    assert ck.purge("dec") == 2
    assert ck.latest_step("decaaaa") is None
    assert ck.latest_step("ckpt") == 3
    assert ck.purge("dec") == 0


def test_checkpoint_async_roundtrip(tmp_path):
    ck = C.Checkpointer(str(tmp_path), async_save=True)
    state = dict(a=torch.ones(4, 4), b=[np.zeros(3), torch.full((2,), 7.0)],
                 n=5, t=(torch.arange(3, dtype=torch.int32), 2.5))
    ck.save(10, state)
    ck.wait()
    step, restored = ck.restore(state)
    assert step == 10
    assert torch.equal(restored["b"][1], torch.full((2,), 7.0))
    assert isinstance(restored["b"][0], np.ndarray)
    assert restored["n"] == 5 and isinstance(restored["n"], int)
    assert isinstance(restored["t"], tuple) and restored["t"][1] == 2.5
    assert restored["t"][0].dtype == torch.int32


def test_checkpoint_async_save_copies_before_returning(tmp_path,
                                                       monkeypatch):
    """A tensor written in place right after an async save (a KV cache
    step, a page reset) must not reach the checkpoint: save copies to
    host before it returns."""
    gate = __import__("threading").Event()
    real = C.np.savez

    def slow_savez(*a, **kw):
        gate.wait(10)
        return real(*a, **kw)

    monkeypatch.setattr(C.np, "savez", slow_savez)
    ck = C.Checkpointer(str(tmp_path), async_save=True)
    ppos = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    cache = torch.ones(3, 4, dtype=torch.bfloat16)
    ck.save(1, dict(ppos=ppos, cache=cache))
    ppos[:, 1] = -1                          # _reset_pages-style writes
    cache.mul_(3)
    gate.set()
    ck.wait()
    _, back = ck.restore(dict(ppos=ppos, cache=cache))
    assert torch.equal(back["ppos"],
                       torch.arange(12, dtype=torch.int32).reshape(3, 4))
    assert torch.equal(back["cache"], torch.ones(3, 4, dtype=torch.bfloat16))


def test_bf16_cache_round_trip_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    k = (torch.randn((2, 3, 5, 1, 8), generator=g) * 7).to(torch.bfloat16)
    k.view(torch.int16)[0, 0, 0, 0, :4] = torch.tensor(
        [0x7F80, -0x0080, 0x0001, 0x7FC1], dtype=torch.int16)  # inf, nan
    ck = C.Checkpointer(str(tmp_path), async_save=False)
    ck.save(0, dict(cache=dict(k=k, pos=torch.full((2, 3), -1))))
    z = np.load(os.path.join(str(tmp_path), "ckpt_00000000", "arrays.npz"))
    assert z["cache/k"].dtype == np.uint16
    template = dict(cache=dict(k=torch.zeros(1, dtype=torch.bfloat16,
                                             device="meta"),
                               pos=torch.zeros(1, dtype=torch.int64,
                                               device="meta")))
    _, back = ck.restore(template)
    assert back["cache"]["k"].dtype == torch.bfloat16
    assert torch.equal(back["cache"]["k"].view(torch.int16),
                       k.view(torch.int16))


def test_decode_checkpointer_restores_onto_the_templates_device(tmp_path):
    """``DecodeCheckpointer.restore`` lands each tensor on its template
    leaf's device unless ``device=`` names one (a meta template leaf: the
    CPU), as ``Checkpointer.restore`` does; it never moves a decode state
    to the CPU on its own."""
    from repro_torch.resilience.checkpoints import DecodeCheckpointer

    ck = DecodeCheckpointer(str(tmp_path))
    state = dict(tok=torch.arange(6, dtype=torch.int32).reshape(2, 3),
                 k=torch.ones(2, 4, dtype=torch.bfloat16))
    ck.commit("dec0", 1, state, emitted=3)

    def template(emitted):
        return dict(tok=torch.zeros(2, emitted, dtype=torch.int32,
                                    device="meta"),
                    k=torch.zeros(2, 4, dtype=torch.bfloat16))

    step, back = ck.restore("dec0", template)
    assert step == 1
    assert back["tok"].device.type == back["k"].device.type == "cpu"
    assert torch.equal(back["tok"], state["tok"])
    assert torch.equal(back["k"], state["k"])
    _, there = ck.restore("dec0", template, device="meta")
    assert there["tok"].is_meta and there["k"].is_meta


def test_checkpoint_async_write_failure_raises(tmp_path, monkeypatch):
    ck = C.Checkpointer(str(tmp_path), async_save=True)
    state = dict(w=torch.ones(2, 2))

    def boom(*a, **kw):
        raise OSError("NV write failed (injected)")

    monkeypatch.setattr(C.np, "savez", boom)
    ck.save(1, state)
    with pytest.raises(C.CheckpointWriteError) as ei:
        ck.wait()
    assert isinstance(ei.value.__cause__, OSError)
    assert ck.latest_step() is None
    monkeypatch.undo()
    ck.save(2, state)
    ck.wait()
    assert ck.latest_step() == 2


def test_checkpoint_async_write_failure_raises_at_next_save(tmp_path,
                                                            monkeypatch):
    ck = C.Checkpointer(str(tmp_path), async_save=True)
    state = dict(w=torch.zeros(3))
    monkeypatch.setattr(C.np, "savez",
                        lambda *a, **kw: (_ for _ in ()).throw(IOError("x")))
    ck.save(1, state)
    if ck._thread is not None:
        ck._thread.join()
    monkeypatch.undo()
    with pytest.raises(C.CheckpointWriteError):
        ck.save(2, state)


# ---------------------------------------------------------------------------
# LM: kill points, resume, bit identity, counters vs the reference
# ---------------------------------------------------------------------------

def _numpy_params(seed: int = 0) -> dict:
    rs = np.random.RandomState(seed)
    L, d, hd = GEOM["n_layers"], GEOM["d_model"], GEOM["head_dim"]
    h, hk, ff = GEOM["n_heads"], GEOM["n_kv_heads"], GEOM["d_ff"]

    def w(*shape):
        return (rs.randn(*shape) / math.sqrt(shape[-2])).astype(np.float32)

    ones = lambda *s: np.ones(s, np.float32)  # noqa: E731
    return {"embed": (rs.randn(256, d) * 0.02).astype(np.float32),
            "final_norm": ones(d),
            "blocks": {"attn": {
                "attn": {"ln": ones(L, d), "wq": w(L, d, h * hd),
                         "wk": w(L, d, hk * hd), "wv": w(L, d, hk * hd),
                         "wo": w(L, h * hd, d)},
                "mlp": {"ln": ones(L, d), "w_in": w(L, d, ff),
                        "w_gate": w(L, d, ff), "w_out": w(L, ff, d)}}}}


@pytest.fixture(scope="module")
def lm():
    jcfg = dataclasses.replace(jget_config("smollm-360m").smoke(**GEOM),
                               quant=JPAPER["w1a8"])
    cfg = dataclasses.replace(get_config("smollm-360m").smoke(**GEOM),
                              quant=PAPER_CONFIGS["w1a8"])
    jp = jprequant(jax.tree.map(jnp.asarray, _numpy_params()), jcfg)
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                          device="cpu")
    prompts = [np.random.RandomState(i).randint(0, GEOM["vocab"], size=(8,))
               .astype(np.int32) for i in range(4)]

    def mk(fault_plan=None, ckdir=None, **kw):
        runner = EpochLMRunner(params, cfg, new_tokens=NEW_TOKENS,
                               epoch_steps=2)
        return ResilientServeEngine(runner, fault_plan=fault_plan,
                                    checkpoint_dir=ckdir, max_batch=4, **kw)

    ref = [r.value for r in mk().serve(prompts)]
    return dict(cfg=cfg, params=params, jcfg=jcfg, jparams=jp,
                prompts=prompts, mk=mk, ref=ref)


def _assert_identical(results, ref):
    assert len(results) == len(ref)
    for r, v in zip(results, ref):
        np.testing.assert_array_equal(r.value, v)


def test_lm_epoch_schedule(lm):
    r = EpochLMRunner(lm["params"], lm["cfg"], new_tokens=8, epoch_steps=3)
    assert r.epoch_schedule() == (3, 3, 1)
    assert r.epoch_schedule(("lm", 8, 5)) == (3, 1)
    r = EpochLMRunner(lm["params"], lm["cfg"], new_tokens=7, epoch_steps=2)
    assert r.epoch_schedule() == (2, 2, 2)
    with pytest.raises(ValueError):
        EpochLMRunner(lm["params"], lm["cfg"], new_tokens=8, epoch_steps=0)


def test_fault_free_epoch_runner_equals_lm_runner(lm):
    """The epochs run the same decode step as LMRunner's loop: equal
    tokens on the same padded batch."""
    plain = ServeEngine(LMRunner(lm["params"], lm["cfg"],
                                 new_tokens=NEW_TOKENS), max_batch=4)
    _assert_identical(plain.serve(lm["prompts"]), lm["ref"])
    assert all(v.shape == (NEW_TOKENS,) for v in lm["ref"])


def test_lm_kill_in_prefill_bit_identical(lm, tmp_path):
    eng = lm["mk"](FaultPlan.scripted([("prefill", 0, "power_loss")]),
                   ckdir=str(tmp_path))
    res = eng.serve(lm["prompts"])
    assert eng.stats["power_losses"] == 1 and eng.stats["retries"] == 4
    _assert_identical(res, lm["ref"])


def test_lm_kill_mid_decode_resumes_from_epoch(lm, tmp_path):
    eng = lm["mk"](FaultPlan.scripted([("decode", 1, "power_loss")]),
                   ckdir=str(tmp_path))
    res = eng.serve(lm["prompts"])
    s = eng.stats
    assert s["prefills"] == 1 and s["resumes"] == 1
    assert s["epochs"] == 3
    assert s["executed_steps"] == s["useful_steps"] == 6
    assert s["commits"] == 4 and s["commit_s"] > 0
    assert not os.listdir(str(tmp_path))   # purged once served
    _assert_identical(res, lm["ref"])


def test_lm_kill_without_checkpoints_restarts_clean(lm):
    eng = lm["mk"](FaultPlan.scripted([("decode", 1, "power_loss")]))
    res = eng.serve(lm["prompts"])
    assert eng.stats["prefills"] == 2 and eng.stats["resumes"] == 0
    _assert_identical(res, lm["ref"])


def test_lm_kill_in_staging_bit_identical(lm, tmp_path):
    eng = lm["mk"](FaultPlan.scripted([("staging", 0, "power_loss")]),
                   ckdir=str(tmp_path))
    res = eng.serve(lm["prompts"])
    assert eng.stats["power_losses"] == 1
    _assert_identical(res, lm["ref"])


def test_lm_staging_corruption_detected_and_restaged(lm):
    eng = lm["mk"](FaultPlan.scripted([("staging", 0,
                                        "staging_corruption")]))
    res = eng.serve(lm["prompts"])
    assert eng.stats["staging_retries"] == 1 and eng.stats["faults"] == 0
    _assert_identical(res, lm["ref"])


def test_lm_device_drop_and_slow_dispatch(lm, tmp_path):
    eng = lm["mk"](FaultPlan.scripted([("decode", 0, "device_drop"),
                                       ("decode", 2, "slow_dispatch")]),
                   ckdir=str(tmp_path))
    res = eng.serve(lm["prompts"])
    assert eng.stats["device_drops"] == 1
    assert eng.stats["slow_dispatches"] == 1
    _assert_identical(res, lm["ref"])


def test_lm_random_chaos_bit_identical(lm, tmp_path):
    eng = lm["mk"](FaultPlan(6.0, seed=3), ckdir=str(tmp_path),
                   max_retries=50)
    res = eng.serve(lm["prompts"])
    assert eng.stats["faults"] >= 1
    assert not eng.dead_letters
    _assert_identical(res, lm["ref"])


def test_lm_idempotent_requeue_no_duplicate_results(lm, tmp_path):
    eng = lm["mk"](FaultPlan.scripted([("prefill", 0, "power_loss"),
                                       ("decode", 1, "power_loss")]),
                   ckdir=str(tmp_path))
    rids = [eng.submit(p) for p in lm["prompts"]]
    res = eng.drain()
    assert [r.rid for r in res] == sorted(rids)
    assert len({r.rid for r in res}) == len(rids)
    _assert_identical(res, lm["ref"])


def test_lm_bf16_cache_resume_bit_identical(lm, tmp_path):
    """The checkpointed KV cache in bfloat16 (the full config's compute
    type) resumes bit for bit."""
    cfg = dataclasses.replace(lm["cfg"], compute_dtype=torch.bfloat16)

    def mk(fp=None, ckdir=None):
        return ResilientServeEngine(
            EpochLMRunner(lm["params"], cfg, new_tokens=NEW_TOKENS,
                          epoch_steps=2),
            fault_plan=fp, checkpoint_dir=ckdir, max_batch=4)

    ref = [r.value for r in mk().serve(lm["prompts"])]
    eng = mk(FaultPlan.scripted([("decode", 2, "power_loss")]),
             str(tmp_path))
    res = eng.serve(lm["prompts"])
    assert eng.stats["resumes"] == 1 and eng.stats["prefills"] == 1
    _assert_identical(res, ref)


@pytest.mark.parametrize("other", ["params", "cfg"])
def test_lm_other_models_checkpoint_is_not_resumed(lm, other, tmp_path):
    """A crash leaves a bucket's epoch commits on disk.  A runner with
    other params or another config tags the same requests differently,
    prefills from scratch and serves its own fault-free tokens; the
    runner that committed resumes from them."""
    def mk(params, cfg):
        return ResilientServeEngine(
            EpochLMRunner(params, cfg, new_tokens=NEW_TOKENS, epoch_steps=2),
            checkpoint_dir=str(tmp_path), max_batch=4)

    crashed = mk(lm["params"], lm["cfg"])
    epoch, calls = crashed.runner.epoch, []

    def dies(*a):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("the node died")
        return epoch(*a)

    crashed.runner.epoch = dies
    with pytest.raises(RuntimeError):
        crashed.serve(lm["prompts"])
    assert os.listdir(str(tmp_path))
    params, cfg = lm["params"], lm["cfg"]
    if other == "params":
        params = dict(params, embed=params["embed"] * 2.0)
    else:
        cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    own = ResilientServeEngine(
        EpochLMRunner(params, cfg, new_tokens=NEW_TOKENS, epoch_steps=2),
        max_batch=4).serve(lm["prompts"])
    foreign = mk(params, cfg)
    assert (foreign.runner.plan_fingerprint()
            != crashed.runner.plan_fingerprint())
    got = foreign.serve(lm["prompts"])
    assert foreign.stats["resumes"] == 0 and foreign.stats["prefills"] == 1
    _assert_identical(got, [r.value for r in own])
    same = mk(lm["params"], lm["cfg"])
    _assert_identical(same.serve(lm["prompts"]), lm["ref"])
    assert same.stats["resumes"] == 1 and same.stats["prefills"] == 0


@pytest.mark.parametrize("plan", [
    lambda M: M.scripted([("prefill", 0, "power_loss"),
                          ("decode", 1, "device_drop"),
                          ("staging", 2, "staging_corruption"),
                          ("decode", 4, "slow_dispatch")]),
    lambda M: M(4.0, seed=11)])
def test_lm_counters_equal_the_reference_engine(lm, tmp_path, plan):
    """Same fault plan, same requests, no degrade: every counter of the
    port's engine equals the reference engine's, and so do the tokens."""
    prompts = lm["prompts"] * 2
    port = ResilientServeEngine(
        EpochLMRunner(lm["params"], lm["cfg"], new_tokens=NEW_TOKENS,
                      epoch_steps=2),
        fault_plan=plan(FaultPlan), checkpoint_dir=str(tmp_path / "t"),
        max_batch=4, max_retries=50)
    ref = JResilientServeEngine(
        JEpochLMRunner(lm["jparams"], lm["jcfg"], new_tokens=NEW_TOKENS,
                       epoch_steps=2),
        fault_plan=plan(JFaultPlan), checkpoint_dir=str(tmp_path / "j"),
        max_batch=4, max_retries=50)
    got, want = port.serve(prompts), ref.serve(prompts)
    assert {k: port.stats[k] for k in COUNTERS} == {
        k: ref.stats[k] for k in COUNTERS}
    assert port.stats["faults"] >= 1
    assert [(e.kind, e.site, e.t, e.offset) for e in port.faults.log] == [
        (e.kind, e.site, e.t, e.offset) for e in ref.faults.log]
    assert [r.rid for r in got] == [r.rid for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.value, np.asarray(b.value))


def test_lm_facade_branch_raises(lm):
    from repro_torch.resilience import build_resilient_engine

    plan = P.compile_model(None, cnn.svhn_cnn_spec(8), W1A8, img_hw=16)
    compiled = api.CompiledModel(dataclasses.replace(plan, kind="lm"))
    # the facade's LM branch is ported; an LM plan without its ArchConfig
    # (no model attached) cannot serve and raises
    with pytest.raises(P.PlanError, match="ArchConfig"):
        build_resilient_engine(compiled, ResilienceConfig())


# ---------------------------------------------------------------------------
# CNN: single-shot dispatch kills, vs the plain engine
# ---------------------------------------------------------------------------

SPEC = cnn.svhn_cnn_spec(8)
IMGS = [np.random.RandomState(i).uniform(size=(16, 16, 3)).astype(np.float32)
        for i in range(4)]


def _compiled(q=W1A8, seed=0):
    params = cnn.init_cnn(torch.Generator().manual_seed(seed), SPEC)
    return api.build(SPEC, q, params=params, img_hw=16).compile(
        batch_hints=(1, 4))


@pytest.fixture(scope="module")
def cnn_pair():
    return _compiled(W1A8), _compiled(W1A1)


def test_cnn_dispatch_kill_bit_identical_to_plain_engine(cnn_pair):
    primary, _ = cnn_pair
    ref = ServeEngine(CNNRunner(primary.plan), max_batch=4).serve(IMGS)
    eng = ResilientServeEngine(
        CNNRunner(primary.plan),
        fault_plan=FaultPlan.scripted([("dispatch", 0, "power_loss"),
                                       ("staging", 1,
                                        "staging_corruption")]),
        max_batch=4)
    res = eng.serve(IMGS)
    assert eng.stats["power_losses"] == 1
    assert eng.stats["staging_retries"] == 1
    assert eng.stats["energy_pj"] == 4 * P.plan_energy_pj(primary.plan)
    for a, b in zip(ref, res):
        np.testing.assert_array_equal(a.value, b.value)


def test_mesh_rejected(cnn_pair):
    with pytest.raises(ValueError, match="mesh"):
        ResilientServeEngine(CNNRunner(cnn_pair[0].plan), mesh=object())


def test_retry_exhaustion_dead_letters(cnn_pair):
    eng = ResilientServeEngine(
        CNNRunner(cnn_pair[0].plan),
        fault_plan=FaultPlan.scripted(
            [("dispatch", i, "power_loss") for i in range(3)]),
        max_batch=4, max_retries=2)
    assert eng.serve(IMGS) == []
    assert set(eng.dead_letters) == set(range(4))
    assert all("retries exhausted" in v for v in eng.dead_letters.values())
    assert eng.stats["dead_lettered"] == 4
    res2 = eng.serve(IMGS)
    assert len(res2) == 4 and set(eng.dead_letters) == set(range(4))


def test_deadline_dead_letters_with_fake_clock(cnn_pair):
    t = [0.0]
    eng = ResilientServeEngine(
        CNNRunner(cnn_pair[0].plan),
        fault_plan=FaultPlan.scripted([("dispatch", 0, "power_loss")]),
        max_batch=4, deadline_s=5.0, clock=lambda: t[0],
        backoff_base_s=0.0, backoff_max_s=0.0)
    for img in IMGS:
        eng.submit(img)
    t[0] = 1.0
    eng.pump()
    t[0] = 10.0
    assert eng.drain() == []
    assert list(eng.dead_letters.values()) == ["deadline"] * 4


def test_backoff_schedule_is_bounded_and_jittered(cnn_pair):
    eng = ResilientServeEngine(
        CNNRunner(cnn_pair[0].plan),
        fault_plan=FaultPlan.scripted(
            [("dispatch", i, "power_loss") for i in range(4)]),
        max_batch=1, max_retries=4, backoff_base_s=0.01, backoff_max_s=0.03,
        clock=lambda: 0.0)
    eng.submit(IMGS[0])
    delays = []
    for _ in range(4):
        eng._flush_all()
        (eligible_at, _), = eng._retry
        delays.append(eligible_at)
        eng._admit_retries(force=True)
    for d, nominal in zip(delays, (0.01, 0.02, 0.03, 0.03)):
        assert 0.5 * nominal <= d < 1.5 * nominal


# ---------------------------------------------------------------------------
# degradation through the facade
# ---------------------------------------------------------------------------

def _plain(compiled):
    return [r.value for r in ServeEngine(CNNRunner(compiled.plan),
                                         max_batch=4).serve(IMGS)]


def test_degrade_swaps_to_fallback_plan(cnn_pair):
    primary, fallback = cnn_pair
    dep = primary.serve(max_batch=4, resilience=ResilienceConfig(
        fault_plan=FaultPlan.scripted([("dispatch", 0, "power_loss"),
                                       ("dispatch", 1, "power_loss")]),
        degrade=DegradePolicy(fault_window=4, fault_threshold=2)),
        fallback=fallback)
    eng = dep.engine
    res = eng.serve(IMGS)
    assert eng.stats["degrades"] == 1 and not eng.dead_letters
    assert set(eng.result_runner.values()) == {1}
    want = P.plan_energy_pj(fallback.plan) / P.plan_energy_pj(primary.plan)
    assert eng._energy_scale == want < 1.0
    for r, v in zip(res, _plain(fallback)):
        np.testing.assert_array_equal(r.value, v)


def test_energy_budget_degrades_between_batches(cnn_pair):
    primary, fallback = cnn_pair
    e = P.plan_energy_pj(primary.plan)
    dep = primary.serve(max_batch=4, resilience=ResilienceConfig(
        degrade=DegradePolicy(energy_budget_pj=4 * e)), fallback=fallback)
    eng = dep.engine
    first = eng.serve(IMGS)
    assert eng.stats["degrades"] == 1
    second = eng.serve(IMGS)
    assert all(eng.result_runner[r.rid] == 0 for r in first)
    assert all(eng.result_runner[r.rid] == 1 for r in second)
    for r, v in zip(second, _plain(fallback)):
        np.testing.assert_array_equal(r.value, v)


def test_equal_energy_fallback_keeps_unit_scale(cnn_pair):
    primary, _ = cnn_pair
    clone = _compiled(W1A8, seed=5)
    assert P.plan_energy_pj(clone.plan) == P.plan_energy_pj(primary.plan)
    dep = primary.serve(max_batch=4, resilience=ResilienceConfig(
        fault_plan=FaultPlan.scripted([("dispatch", 0, "power_loss"),
                                       ("dispatch", 1, "power_loss")]),
        degrade=DegradePolicy(fault_window=4, fault_threshold=2)),
        fallback=clone)
    eng = dep.engine
    assert len(eng.serve(IMGS)) == 4
    assert eng.stats["degrades"] == 1 and eng._energy_scale == 1.0


def test_recovery_rearms_primary_plan(cnn_pair):
    primary, fallback = cnn_pair
    dep = primary.serve(max_batch=4, resilience=ResilienceConfig(
        fault_plan=FaultPlan.scripted([("dispatch", 0, "power_loss"),
                                       ("dispatch", 1, "power_loss")]),
        degrade=DegradePolicy(fault_window=4, fault_threshold=2,
                              recover_after=1)), fallback=fallback)
    eng = dep.engine
    first = eng.serve(IMGS)
    assert eng.stats["degrades"] == 1 and eng.stats["recoveries"] == 1
    assert eng._active == 0 and eng._energy_scale == 1.0
    assert all(eng.result_runner[r.rid] == 1 for r in first)
    second = eng.serve(IMGS)
    assert all(eng.result_runner[r.rid] == 0 for r in second)
    for r, v in zip(second, _plain(primary)):
        np.testing.assert_array_equal(r.value, v)


def test_api_serve_resilience_roundtrip(cnn_pair):
    primary, _ = cnn_pair
    dep = primary.serve(max_batch=4, resilience=ResilienceConfig(
        fault_plan=FaultPlan.scripted([("dispatch", 0, "device_drop")])))
    assert isinstance(dep.engine, ResilientServeEngine)
    got = dep.predict(IMGS)
    assert dep.stats["device_drops"] == 1
    for a, b in zip(got, _plain(primary)):
        np.testing.assert_array_equal(a, b)
