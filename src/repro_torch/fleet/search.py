"""Per-node plan co-design search over the fleet (port of
``repro/fleet/search.py``).

Each node's operating point is a candidate ``(quant, pim_target,
checkpoint_period)``.  The search couples two frontiers:

* **complexity/accuracy** — Table-I test error per quant config, read from
  ``results/bench_rows.json`` (the reference's ``benchmarks/run.py``
  output) when present, else the pinned reference numbers below; a node's
  accuracy SLO (max test-error %) filters which quants it may run.
* **energy/latency** — the plan's Table-II-pinned per-frame cost on each
  PIM target, priced by ``core/plan.plan_cost_on`` from ONE structure-only
  compiled plan per quant (no weights, no tensors: pure cost model).

Feasible candidates are scored by simulating the node's harvest trace
(:mod:`repro_torch.fleet.sim`).  The baseline every result is reported
against is the best ONE-CONFIG-FITS-ALL candidate: the single operating
point feasible under every node's SLO that maximizes fleet
inferences/day.

Everything is a pure function of (traces, SLO seed, candidate space).
"""
from __future__ import annotations

import json
import os

import numpy as np

from .sim import NodeConfig, simulate_node
from .traces import HarvestTrace, TraceSpec, make_trace

# Table-I synthetic-SVHN test error (%), benchmarks/paper_tables.py
# table1_accuracy(steps=120) — regenerate with `python benchmarks/run.py`
# and the loader below picks up the fresh numbers from bench_rows.json.
REFERENCE_ERROR_PCT = {
    "w32a32": 7.03, "w1a1": 9.96, "w1a4": 5.08, "w1a8": 8.4, "w2a2": 12.89,
}

# quantized operating points only: fp32 has no PIM mapping story
DEFAULT_QUANTS = ("w1a1", "w1a4", "w1a8", "w2a2")
DEFAULT_TARGETS = ("sot_mram", "imce", "reram", "cmos_asic")
DEFAULT_PERIODS = (1, 10, 50)

# per-node accuracy SLOs (max tolerated test-error %), spanning the
# Table-I frontier: 6.0 admits only w1a4, 13.0 admits every quant
SLO_LEVELS = (6.0, 9.0, 10.5, 13.0)


def load_accuracy_table(path: str | None = "results/bench_rows.json") -> dict:
    """Quant -> test-error %.  Prefers measured Table-I rows from a
    ``benchmarks/run.py`` artifact; falls back to the pinned reference."""
    table = dict(REFERENCE_ERROR_PCT)
    if path and os.path.exists(path):
        try:
            with open(path) as f:
                rows = json.load(f).get("table1_accuracy") or []
            for row in rows:
                if "test_error_pct" in row:
                    table[row["config"]] = float(row["test_error_pct"])
        except (OSError, ValueError, KeyError, TypeError):
            pass   # unreadable artifact -> pinned reference
    return table


def frame_cost_table(quants=DEFAULT_QUANTS, targets=DEFAULT_TARGETS, *,
                     channels: int = 20, img_hw: int = 40) -> dict:
    """(quant, target) -> ``(frame_energy_uj, frame_time_us)`` for the
    paper's SVHN CNN: one structure-only compile per quant, re-priced on
    every PIM target through ``plan_cost_on`` (bit-identical Table-II
    arithmetic; the plans are structure-only on target ``cuda``, as
    ``api/reports`` compiles them: pricing reads only each layer's
    geometry and bit widths, so no tensor is made)."""
    from repro_torch.core.plan import compile_model, plan_cost_on
    from repro_torch.core.quant import PAPER_CONFIGS
    from repro_torch.models.cnn import svhn_cnn_spec

    costs = {}
    for q in quants:
        plan = compile_model(None, svhn_cnn_spec(channels), PAPER_CONFIGS[q],
                             target="cuda", img_hw=img_hw, model="svhn_cnn")
        for t in targets:
            r = plan_cost_on(plan, t)
            costs[(q, t)] = (float(r["energy_uj"]), float(r["latency_us"]))
    return costs


def candidate_space(costs: dict, *, quants=DEFAULT_QUANTS,
                    targets=DEFAULT_TARGETS,
                    periods=DEFAULT_PERIODS) -> list[tuple[str, str, int]]:
    """All (quant, target, period) triples, with per-quant Pareto pruning
    over targets: a target strictly worse in BOTH frame energy and frame
    latency than another can never win a node (the simulator is monotone
    in each at fixed harvest), so it is dropped before the O(nodes x
    candidates) simulation loop."""
    cands = []
    for q in quants:
        keep = []
        for t in targets:
            e, lat = costs[(q, t)]
            if any(costs[(q, o)][0] <= e and costs[(q, o)][1] <= lat
                   and costs[(q, o)] != costs[(q, t)]
                   for o in targets if o != t):
                continue
            keep.append(t)
        for t in keep:
            for p in periods:
                cands.append((q, t, int(p)))
    return cands


def assign_slos(n_nodes: int, seed: int = 0, levels=SLO_LEVELS) -> list[float]:
    """Deterministic per-node accuracy SLO draw (uniform over levels)."""
    rng = np.random.RandomState(seed)
    levels = tuple(float(x) for x in levels)
    return [levels[int(i)] for i in rng.randint(0, len(levels),
                                                size=n_nodes)]


def _node_config(node_id: str, cand, costs, node_kw) -> NodeConfig:
    q, t, p = cand
    e, lat = costs[(q, t)]
    return NodeConfig(node_id=node_id, quant=q, target=t, period=p,
                      frame_energy_uj=e, frame_time_us=lat, **node_kw)


def codesign(traces, slos, *, accuracy=None, costs=None, candidates=None,
             node_kw=None) -> dict:
    """Per-node co-design search + one-config-fits-all baseline + Pareto.

    For each node, every SLO-feasible candidate is simulated on the node's
    own trace and the inferences/day argmax wins (ties break to higher
    forward-progress efficiency, then candidate order — deterministic).
    The per-(node, candidate) results are reused to score every globally-
    feasible uniform config, so the baseline costs no extra simulation.

    ``traces``: HarvestTrace/TraceSpec list.  ``slos``: per-node max
    test-error %.  ``node_kw``: shared NodeConfig knobs (resume_us,
    cap_uj, ...).  Returns assignments, fleet aggregates, the baseline,
    and the (inferences/day, worst-case error) Pareto frontier over
    uniform configs plus the co-design point.
    """
    traces = [make_trace(tr) if isinstance(tr, TraceSpec) else tr
              for tr in traces]
    if len(traces) != len(slos):
        raise ValueError(f"got {len(traces)} traces but {len(slos)} SLOs")
    accuracy = accuracy if accuracy is not None else load_accuracy_table()
    costs = costs if costs is not None else frame_cost_table()
    candidates = (candidates if candidates is not None
                  else candidate_space(costs))
    node_kw = dict(node_kw or {})
    infeasible = [s for s in slos
                  if not any(accuracy[q] <= s for q, _, _ in candidates)]
    if infeasible:
        raise ValueError(f"no candidate quant meets SLO {min(infeasible)} "
                         f"(best error: "
                         f"{min(accuracy[q] for q, _, _ in candidates)})")

    assignments, chosen_results = [], []
    # candidate -> summed fleet inferences/day, only while feasible for
    # every node seen so far (the uniform-baseline bookkeeping)
    uniform_ipd = {c: 0.0 for c in candidates
                   if all(accuracy[c[0]] <= s for s in slos)}
    for trace, slo in zip(traces, slos):
        nid = trace.spec.node_id
        best, best_key = None, None
        for cand in candidates:
            if accuracy[cand[0]] > slo:
                continue
            r = simulate_node(trace, _node_config(nid, cand, costs, node_kw))
            if cand in uniform_ipd:
                uniform_ipd[cand] += r["inferences_per_day"]
            key = (r["inferences_per_day"], r["efficiency"])
            if best is None or key > best_key:
                best, best_key = (cand, r), key
        cand, r = best
        assignments.append(dict(node_id=nid, quant=cand[0], target=cand[1],
                                period=cand[2], slo_error_pct=slo,
                                error_pct=accuracy[cand[0]],
                                inferences_per_day=r["inferences_per_day"],
                                efficiency=r["efficiency"], dead=r["dead"]))
        chosen_results.append(r)

    codesign_ipd = float(sum(a["inferences_per_day"] for a in assignments))
    if not uniform_ipd:
        raise ValueError("no single candidate is feasible for every node's "
                         "SLO — one-config-fits-all baseline undefined")
    base_cand = max(uniform_ipd, key=lambda c: (uniform_ipd[c],
                                                -candidates.index(c)))
    baseline_ipd = float(uniform_ipd[base_cand])

    # Pareto over uniform configs: (fleet inferences/day, error %); the
    # co-design point's "error" is its worst assigned error (every node
    # individually meets its own SLO by construction)
    points = [dict(kind="uniform", quant=c[0], target=c[1], period=c[2],
                   inferences_per_day=float(v), error_pct=accuracy[c[0]])
              for c, v in sorted(uniform_ipd.items())]
    points.append(dict(kind="codesign", inferences_per_day=codesign_ipd,
                       error_pct=max(a["error_pct"] for a in assignments)))
    frontier = [p for p in points
                if not any(o["inferences_per_day"] > p["inferences_per_day"]
                           and o["error_pct"] <= p["error_pct"]
                           for o in points)]
    return dict(
        assignments=assignments,
        results=chosen_results,
        inferences_per_day=codesign_ipd,
        baseline=dict(quant=base_cand[0], target=base_cand[1],
                      period=base_cand[2],
                      inferences_per_day=baseline_ipd,
                      error_pct=accuracy[base_cand[0]]),
        win_vs_baseline=(codesign_ipd / baseline_ipd
                         if baseline_ipd > 0 else float("inf")),
        slo_violations=sum(1 for a in assignments
                           if a["error_pct"] > a["slo_error_pct"]),
        pareto=frontier,
        candidates=[list(c) for c in candidates],
    )
