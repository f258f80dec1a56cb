"""The port's fleet simulator (``repro_torch.fleet``) held against the
reference's (``repro.fleet``) on equal inputs, on the CPU.

Tolerances: every comparison is exact.  Traces, the fluid node walk, the
fleet report, the engine-accounting mirror, the frame costs and the
co-design search run the same numpy and Python float arithmetic in the
same order on both sides, so arrays are equal bit for bit and every
float field (efficiency, joules, inferences/day, wasted steps, frame
energy and latency) is equal, not within a tolerance.  The one arm that
serves a model, ``live_validation``, is held by its own contract
(integer counters exact, floats within 1e-6 of the mirror's prediction)
and, since its counters depend on the fault schedule and the request
geometry but not on the weights, by equality with the reference's
``live_validation`` counters on the same schedule.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import fleet as jfleet  # noqa: E402
from repro.fleet import sim as jsim  # noqa: E402
from repro.resilience import faults as jfaults  # noqa: E402
from repro_torch import api, fleet  # noqa: E402
from repro_torch.fleet import sim  # noqa: E402
from repro_torch.resilience import faults  # noqa: E402

SPECS = [("solar", 1), ("solar", 7), ("rf", 2), ("rf", 11), ("thermal", 3),
         ("thermal", 5)]


def _node(mod, **kw):
    base = dict(node_id="n0", quant="w1a4", target="sot_mram", period=5,
                frame_energy_uj=50.0, frame_time_us=100.0, nv_write_us=1.0,
                resume_us=0.0, cap_uj=10_000.0, wake_frac=0.5)
    base.update(kw)
    return mod.NodeConfig(**base)


def _spec(mod, archetype, seed, **kw):
    return mod.TraceSpec(node_id=f"{archetype}{seed}", archetype=archetype,
                         seed=seed, **kw)


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("archetype,seed", SPECS)
def test_make_trace_equals_reference_bit_for_bit(archetype, seed):
    got = fleet.make_trace(_spec(fleet, archetype, seed))
    want = jfleet.make_trace(_spec(jfleet, archetype, seed))
    assert got.power_mw.dtype == want.power_mw.dtype
    np.testing.assert_array_equal(got.power_mw, want.power_mw)
    assert got.to_json() == want.to_json()
    assert got.to_json(embed_power=True) == want.to_json(
        embed_power=True)


@pytest.mark.parametrize("n,seed", [(5, 0), (12, 3), (40, 9)])
def test_generate_fleet_equals_reference(n, seed):
    got = fleet.generate_fleet(n, seed=seed, duration_s=3600.0)
    want = jfleet.generate_fleet(n, seed=seed, duration_s=3600.0)
    assert [dataclasses.asdict(s) for s in got] == [
        dataclasses.asdict(s) for s in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(fleet.make_trace(g).power_mw,
                                      jfleet.make_trace(w).power_mw)


def test_trace_json_round_trip_reads_the_reference_json():
    spec = _spec(jfleet, "rf", 4, duration_s=7200.0)
    for embed in (False, True):
        text = json.dumps(jfleet.make_trace(spec).to_json(
            embed_power=embed))
        got = fleet.HarvestTrace.from_json(json.loads(text))
        np.testing.assert_array_equal(got.power_mw,
                                      jfleet.make_trace(spec).power_mw)


# ---------------------------------------------------------------------------
# the fluid arm
# ---------------------------------------------------------------------------

NODE_CASES = {
    "ample harvest": dict(power=10.0, node={}),
    "duty cycling": dict(power=0.2, node={}),
    "resume overhead": dict(power=0.3, node=dict(resume_us=2000.0,
                                                 period=10)),
    "dead node": dict(power=0.0, node={}),
    "bulk cycles": dict(power=0.05, node=dict(cap_uj=500.0, period=1)),
}


@pytest.mark.parametrize("case", sorted(NODE_CASES))
def test_simulate_node_equals_reference_on_a_constant_trace(case):
    c = NODE_CASES[case]

    def run(mod):
        spec = mod.TraceSpec(node_id="n0", archetype="thermal", seed=0,
                             dt_s=60.0, duration_s=3600.0)
        trace = mod.HarvestTrace(spec, np.full(spec.n_samples, c["power"]))
        return mod.simulate_node(trace, _node(mod, **c["node"]),
                                 collect_outages=6)

    assert run(fleet) == run(jfleet)


@pytest.mark.parametrize("archetype,seed", SPECS)
def test_simulate_node_equals_reference_on_a_harvest_day(archetype, seed):
    def run(mod):
        return mod.simulate_node(mod.make_trace(_spec(mod, archetype, seed)),
                                 _node(mod, period=10, resume_us=500.0),
                                 collect_outages=8)

    got, want = run(fleet), run(jfleet)
    assert got == want
    assert json.dumps(got) == json.dumps(want)


def _fleet_results(mod, n=10, seed=1):
    specs = mod.generate_fleet(n, seed=seed, duration_s=6 * 3600.0)
    traces = [mod.make_trace(s) for s in specs]
    cfgs = [_node(mod, node_id=s.node_id, period=1 + i % 4)
            for i, s in enumerate(specs)]
    return specs, mod.simulate_fleet(traces, cfgs)


def test_simulate_fleet_and_fleet_report_equal_reference():
    specs, got = _fleet_results(fleet)
    jspecs, want = _fleet_results(jfleet)
    assert got == want
    assert fleet.fleet_report(got, specs) == jfleet.fleet_report(want,
                                                                 jspecs)
    assert fleet.fleet_report(got) == jfleet.fleet_report(want)
    with pytest.raises(ValueError, match="configs"):
        fleet.simulate_fleet([fleet.make_trace(specs[0])], [])


# ---------------------------------------------------------------------------
# the discrete arm
# ---------------------------------------------------------------------------

def test_sim_constants_mirror_the_ports_engine():
    from repro_torch.resilience import engine as real

    assert sim.STAGING_DT == real.STAGING_DT == jsim.STAGING_DT
    assert sim.PREFILL_DT == real.PREFILL_DT == jsim.PREFILL_DT
    assert sim._VALIDATE_INT_KEYS == jsim._VALIDATE_INT_KEYS
    assert sim._VALIDATE_FLOAT_KEYS == jsim._VALIDATE_FLOAT_KEYS


@pytest.mark.parametrize("outages", [[], [2.0], [1.5, 4.0, 4.0],
                                     [0.1, 3.0, 9.5, 9.75, 20.0]])
def test_outage_faultplan_json_equals_reference(outages):
    got = fleet.outage_faultplan(outages)
    want = jfleet.outage_faultplan(outages)
    assert isinstance(got, faults.FaultPlan)
    assert got.to_json() == want.to_json()
    # each side reads the other's spec
    assert faults.FaultPlan.from_json(want.to_json()).to_json() == \
        got.to_json()
    assert jfaults.FaultPlan.from_json(got.to_json()).to_json() == \
        want.to_json()


@pytest.mark.parametrize("frames,work,engine_work", [
    ([10.0, 20.0], 40.0, 8.0), ([], 0.0, 8.0), ([3.3, 7.1, 99.0], 120.5, 17.0)])
def test_rescale_outages_equals_reference(frames, work, engine_work):
    assert fleet.rescale_outages(frames, work, engine_work) == \
        jfleet.rescale_outages(frames, work, engine_work)


@pytest.mark.parametrize("nt,es", [(7, 2), (8, 3), (5, 5), (2, 4), (17, 4)])
def test_epoch_schedule_equals_reference_and_the_ports_runner(nt, es):
    from repro_torch.resilience import EpochLMRunner

    assert fleet.epoch_schedule(nt, es) == jfleet.epoch_schedule(nt, es)
    r = object.__new__(EpochLMRunner)   # the schedule reads only these two
    r.new_tokens, r.epoch_steps = nt, es
    assert fleet.epoch_schedule(nt, es) == r.epoch_schedule()


PREDICT_CASES = [
    ([], dict(n_requests=8, new_tokens=7, epoch_steps=2, max_batch=4)),
    ([2.0], dict(n_requests=4, new_tokens=7, epoch_steps=2, max_batch=4)),
    ([1.5, 4.0, 4.0], dict(n_requests=8, new_tokens=7, epoch_steps=2,
                           max_batch=4)),
    ([0.1, 3.0, 9.5, 9.75, 20.0], dict(n_requests=10, new_tokens=9,
                                       epoch_steps=3, max_batch=4)),
]


@pytest.mark.parametrize("outages,kw", PREDICT_CASES)
def test_predict_engine_stats_and_efficiency_equal_reference(outages, kw):
    got = fleet.predict_engine_stats(fleet.outage_faultplan(outages), **kw)
    want = jfleet.predict_engine_stats(jfleet.outage_faultplan(outages),
                                       **kw)
    assert got == want
    # from the JSON spec too
    assert fleet.predict_engine_stats(
        fleet.outage_faultplan(outages).to_json(), **kw) == want
    for nv in (0.0, 0.5):
        assert fleet.measured_efficiency(got, nv) == \
            jfleet.measured_efficiency(want, nv)


def test_live_validation_on_cpu_is_ok_and_counts_as_the_reference(tmp_path):
    """The port's replay through its own ``ResilientServeEngine`` (a tiny
    W1A8 LM on the CPU) meets the contract, and its measured counters
    equal the reference's ``live_validation`` on the same schedule."""
    kw = dict(n_requests=8, new_tokens=7, epoch_steps=2, max_batch=4,
              tol=1e-6)
    got = fleet.live_validation([3.0, 9.5], checkpoint_dir=str(
        tmp_path / "port"), device="cpu", **kw)
    assert got["ok"], got["deltas"]
    assert got["device"] == "cpu"
    assert got["completed"] == 8 and got["dead_letters"] == 0
    assert got["measured"]["power_losses"] == 2
    assert all(d == 0 for k, d in got["deltas"].items()
               if k in sim._VALIDATE_INT_KEYS)
    want = jfleet.live_validation([3.0, 9.5], checkpoint_dir=str(
        tmp_path / "ref"), **kw)
    assert want["ok"]
    assert got["measured"] == want["measured"]
    assert got["predicted"] == want["predicted"]
    assert got["fault_spec"] == want["fault_spec"]
    assert got["efficiency_measured"] == want["efficiency_measured"]


# ---------------------------------------------------------------------------
# the co-design search
# ---------------------------------------------------------------------------

def test_frame_cost_table_equals_reference_float_for_float():
    got = fleet.frame_cost_table()
    want = jfleet.frame_cost_table()
    assert got == want
    assert set(got) == {(q, t) for q in ("w1a1", "w1a4", "w1a8", "w2a2")
                        for t in ("sot_mram", "imce", "reram", "cmos_asic")}


def test_load_accuracy_table_keeps_the_path_and_its_fallback(tmp_path):
    assert fleet.load_accuracy_table() == jfleet.load_accuracy_table()
    assert fleet.REFERENCE_ERROR_PCT == jfleet.REFERENCE_ERROR_PCT
    assert fleet.SLO_LEVELS == jfleet.SLO_LEVELS
    rows = tmp_path / "bench_rows.json"
    rows.write_text(json.dumps({"table1_accuracy": [
        {"config": "w1a4", "test_error_pct": 4.5}, {"config": "w1a1"}]}))
    assert fleet.load_accuracy_table(str(rows)) == \
        jfleet.load_accuracy_table(str(rows))
    assert fleet.load_accuracy_table(str(rows))["w1a4"] == 4.5
    rows.write_text("not json")
    assert fleet.load_accuracy_table(str(rows)) == fleet.REFERENCE_ERROR_PCT


_ACC = {"wA": 5.0, "wB": 10.0}
_COSTS = {("wA", "fast"): (100.0, 200.0), ("wA", "slow"): (150.0, 400.0),
          ("wB", "fast"): (40.0, 120.0), ("wB", "slow"): (60.0, 300.0)}


@pytest.mark.parametrize("costs", ["synthetic", "frame_cost_table"])
def test_candidate_space_equals_reference(costs):
    if costs == "synthetic":
        kw = dict(quants=("wA", "wB"), targets=("fast", "slow"),
                  periods=(1, 10))
        assert fleet.candidate_space(_COSTS, **kw) == \
            jfleet.candidate_space(_COSTS, **kw)
    else:
        table = fleet.frame_cost_table()
        assert fleet.candidate_space(table) == jfleet.candidate_space(table)


@pytest.mark.parametrize("n,seed", [(50, 9), (17, 0)])
def test_assign_slos_equals_reference(n, seed):
    assert fleet.assign_slos(n, seed=seed) == jfleet.assign_slos(n,
                                                                 seed=seed)


@pytest.mark.parametrize("which", ["synthetic", "paper"])
def test_codesign_assignments_equal_reference(which):
    """The whole search, on the same traces and SLOs: assignments, the
    chosen nodes' results, the baseline and the Pareto frontier equal."""
    def run(mod):
        specs = mod.generate_fleet(8, seed=2, duration_s=6 * 3600.0)
        traces = [mod.make_trace(s) for s in specs]
        if which == "synthetic":
            slos = [5.5 if i % 2 else 12.0 for i in range(8)]
            return mod.codesign(traces, slos, accuracy=_ACC, costs=_COSTS,
                                candidates=mod.candidate_space(
                                    _COSTS, quants=("wA", "wB"),
                                    targets=("fast", "slow"),
                                    periods=(1, 10)),
                                node_kw=dict(cap_uj=10_000.0))
        return mod.codesign(traces, mod.assign_slos(8, seed=1),
                            node_kw=dict(cap_uj=20_000.0, resume_us=100.0))

    got, want = run(fleet), run(jfleet)
    assert got == want
    assert got["slo_violations"] == 0


def test_api_reexports_the_fleet():
    assert api.fleet is fleet
    for name in jfleet.__all__:
        assert hasattr(api.fleet, name), name
    assert sorted(fleet.__all__) == sorted(jfleet.__all__)
