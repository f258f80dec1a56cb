"""Fleet-scale intermittency simulator (port of ``repro/fleet/sim.py``).

Steps thousands of battery-less nodes through seeded harvest traces
(:mod:`repro_torch.fleet.traces`) and prices each node's forward progress
with its compiled plan's cost on its PIM target (``core/plan.plan_cost_on``
— the Table-II-pinned ``(energy_uj, latency_us)`` per frame), charging NV
checkpoint commits at the node's period P and a resume overhead after
every outage, exactly the accounting of ``pim/intermittent``.

Two arms, one failure model:

* **fluid arm** (:func:`simulate_node`) — closed-form segment walking for
  fleet scale, numpy and Python floats only, the reference's arithmetic
  step for step.  A node alternates ON (buffer drains at the plan's
  active power minus harvest) and OFF (recharge to the wake threshold);
  an outage fires when the buffer empties, losing the frames since the
  last NV commit.  Within a constant-power trace segment the charge/run
  cycle repeats identically, so k cycles collapse to one closed form.
* **discrete arm** (:func:`predict_engine_stats` + :func:`live_validation`)
  — the fluid arm's derived outage instants become a
  ``FaultPlan.timeline`` (power_loss at fixed work-clock times), which is
  polled by BOTH a step-exact mirror of ``ResilientServeEngine``'s hook
  sequence and the port's real engine serving a tiny LM on a device.
  The validation contract is stated in :func:`live_validation`: integer
  work counters match exactly, float accounting within ``tol``.

Determinism: everything here is a pure function of (trace specs, node
configs): no wall clock, no ambient randomness.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.resilience.faults import (DEVICE_DROP, POWER_LOSS,
                                           SLOW_DISPATCH, STAGING_CORRUPTION,
                                           FaultPlan)
from .traces import DAY_S, HarvestTrace

# Mirror of the engine's non-decode hook charges (resilience/engine.py).
# Defined locally so the fluid simulator imports without torch's serve
# stack; a unit test pins these against the engine's own constants.
STAGING_DT = 0.25
PREFILL_DT = 1.0

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Node configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NodeConfig:
    """One node's operating point + energy front-end.

    ``frame_energy_uj`` / ``frame_time_us`` price one inference of the
    node's compiled plan on its PIM target
    (``core/plan.plan_cost_on(plan, target)``); ``period`` is the paper's
    P (frames per NV commit, >= 1 — results are durable only at commits);
    ``resume_us`` is the reboot overhead after every outage (plan reload,
    cf. ``pim/intermittent.plan_resume_study``); ``cap_uj`` is the energy
    buffer and ``wake_frac`` the recharge fraction at which a dark node
    restarts.  The node draws constant active power
    ``frame_energy_uj / frame_time_us`` whenever ON (computing, committing,
    or resuming) and nothing while OFF.
    """

    node_id: str
    quant: str
    target: str
    period: int
    frame_energy_uj: float
    frame_time_us: float
    nv_write_us: float = 1.0
    resume_us: float = 0.0
    cap_uj: float = 200_000.0     # ~0.2 J: a small supercap
    wake_frac: float = 0.5

    def __post_init__(self):
        if self.period < 1:
            raise ValueError(f"period must be >= 1 (results are durable "
                             f"only at NV commits), got {self.period}")
        if self.frame_energy_uj <= 0 or self.frame_time_us <= 0:
            raise ValueError(f"frame_energy_uj and frame_time_us must be "
                             f"positive, got {self.frame_energy_uj}, "
                             f"{self.frame_time_us}")
        if self.nv_write_us < 0 or self.resume_us < 0:
            raise ValueError(f"nv_write_us and resume_us must be >= 0, got "
                             f"{self.nv_write_us}, {self.resume_us}")
        if self.cap_uj <= 0 or not 0 < self.wake_frac <= 1:
            raise ValueError(f"cap_uj must be positive and wake_frac in "
                             f"(0, 1], got {self.cap_uj}, {self.wake_frac}")

    # derived, all in SI-ish units: seconds, uJ, uJ/s
    @property
    def t_frame_s(self) -> float:
        return self.frame_time_us * 1e-6

    @property
    def t_commit_s(self) -> float:
        return self.nv_write_us * 1e-6

    @property
    def t_resume_s(self) -> float:
        return self.resume_us * 1e-6

    @property
    def block_s(self) -> float:
        """One commit block: P frames + the NV write."""
        return self.period * self.t_frame_s + self.t_commit_s

    @property
    def p_active_ujps(self) -> float:
        """Active draw in uJ/s (constant while ON)."""
        return self.frame_energy_uj / self.t_frame_s

    @property
    def wake_uj(self) -> float:
        return self.wake_frac * self.cap_uj


# ---------------------------------------------------------------------------
# Fluid arm: closed-form node simulation
# ---------------------------------------------------------------------------

class _NodeState:
    """Mutable walk state + accounting for one node."""

    __slots__ = ("cfg", "on", "b", "blk", "resume_left", "committed",
                 "wasted", "failures", "on_s", "off_s", "resume_s",
                 "harvested_uj", "outages", "collect")

    def __init__(self, cfg: NodeConfig, collect: int):
        self.cfg = cfg
        self.on = True                 # boot with a full buffer
        self.b = cfg.cap_uj
        self.blk = 0.0                 # seconds into the current commit block
        self.resume_left = cfg.t_resume_s   # cold boot pays one resume
        self.committed = 0.0           # durable frames
        self.wasted = 0.0              # frames lost to outages
        self.failures = 0
        self.on_s = 0.0
        self.off_s = 0.0
        self.resume_s = 0.0
        self.harvested_uj = 0.0
        self.outages: list[float] = []
        self.collect = collect

    def _in_flight(self) -> float:
        """Frames sitting volatile at block offset ``blk`` (frames complete
        during the first P*t_frame of a block; the commit tail adds none)."""
        return min(float(self.cfg.period), self.blk / self.cfg.t_frame_s)

    def _work_clock(self) -> float:
        """Total attempted frames so far (committed + wasted + in-flight) —
        the logical clock outage instants are recorded on, and the clock
        the engine replay's ``FaultPlan.timeline`` is polled against."""
        return self.committed + self.wasted + self._in_flight()

    def _advance_on(self, span_s: float) -> None:
        """``span_s`` of uninterrupted ON time: resume debt first, then
        productive blocks (commits at block boundaries, O(1) via divmod)."""
        self.on_s += span_s
        burn = min(self.resume_left, span_s)
        self.resume_left -= burn
        self.resume_s += burn
        productive = span_s - burn
        if productive <= 0:
            return
        self.blk += productive
        nblocks = int(self.blk / self.cfg.block_s)
        if nblocks:
            self.committed += nblocks * self.cfg.period
            self.blk -= nblocks * self.cfg.block_s

    def _outage(self) -> None:
        """Buffer hit empty while ON: lose the volatile in-flight frames."""
        lost = self._in_flight()
        self.blk = 0.0
        self.wasted += lost
        self.failures += 1
        if len(self.outages) < self.collect:
            self.outages.append(self._work_clock())
        self.on = False
        self.b = 0.0
        self.resume_left = 0.0   # an interrupted resume restarts from scratch

    def _wake(self) -> None:
        self.on = True
        self.b = self.cfg.wake_uj
        self.resume_left = self.cfg.t_resume_s
        self.blk = 0.0

    def _bulk_cycles(self, k: int, t_charge: float, t_run: float) -> None:
        """Apply ``k`` identical charge->resume->run->outage cycles in
        closed form (the node starts each one dark with an empty buffer)."""
        cfg = self.cfg
        burn = min(cfg.t_resume_s, t_run)
        productive = t_run - burn
        nblocks = int(productive / cfg.block_s)
        rem = productive - nblocks * cfg.block_s
        per_committed = nblocks * cfg.period
        per_lost = min(float(cfg.period), rem / cfg.t_frame_s)
        if self.collect and len(self.outages) < self.collect:
            base = self.committed + self.wasted
            for j in range(min(k, self.collect - len(self.outages))):
                self.outages.append(base + (j + 1) * (per_committed
                                                      + per_lost))
        self.off_s += k * t_charge
        self.on_s += k * t_run
        self.resume_s += k * burn
        self.committed += k * per_committed
        self.wasted += k * per_lost
        self.failures += k
        # cycle invariant: ends dark, empty, no block in flight
        self.on = False
        self.b = 0.0
        self.blk = 0.0
        self.resume_left = 0.0


def simulate_node(trace: HarvestTrace, cfg: NodeConfig,
                  collect_outages: int = 0) -> dict:
    """Walk one node through its trace; returns progress statistics.

    ``collect_outages > 0`` additionally records the work-clock instants
    (in frames) of the first that-many outages — the schedule handed to
    :func:`outage_faultplan` for the live-engine arm.
    """
    st = _NodeState(cfg, collect_outages)
    p_active = cfg.p_active_ujps
    dt = trace.dt_s
    for p_mw in trace.power_mw:
        h = float(p_mw) * 1e3          # mW -> uJ/s
        st.harvested_uj += h * dt
        remaining = dt
        while remaining > _EPS:
            if st.on:
                drain = p_active - h
                if drain <= 0:
                    st._advance_on(remaining)
                    st.b = min(cfg.cap_uj, st.b - drain * remaining)
                    remaining = 0.0
                    continue
                t_empty = st.b / drain
                if t_empty >= remaining:
                    st._advance_on(remaining)
                    st.b -= drain * remaining
                    remaining = 0.0
                else:
                    st._advance_on(t_empty)
                    remaining -= t_empty
                    st._outage()
                continue
            # OFF: recharge toward the wake threshold
            if h <= _EPS:
                st.off_s += remaining
                remaining = 0.0
                continue
            if st.b <= _EPS and h < p_active:
                # dark with an empty buffer at constant insufficient
                # harvest: the charge/run cycle repeats identically —
                # collapse every whole cycle left in this segment
                t_charge = cfg.wake_uj / h
                t_run = cfg.wake_uj / (p_active - h)
                k = int(remaining / (t_charge + t_run))
                if k >= 1:
                    st._bulk_cycles(k, t_charge, t_run)
                    remaining -= k * (t_charge + t_run)
                    continue
            t_charge = (cfg.wake_uj - st.b) / h
            if t_charge >= remaining:
                st.b += h * remaining
                st.off_s += remaining
                remaining = 0.0
            else:
                st.off_s += t_charge
                remaining -= t_charge
                st._wake()
    useful_s = st.committed * cfg.t_frame_s
    return dict(
        node_id=cfg.node_id,
        quant=cfg.quant, target=cfg.target, period=cfg.period,
        committed_frames=st.committed,
        wasted_frames=st.wasted,
        failures=st.failures,
        on_s=st.on_s, off_s=st.off_s, resume_s=st.resume_s,
        harvested_j=st.harvested_uj * 1e-6,
        consumed_j=st.on_s * p_active * 1e-6,
        # forward-progress efficiency: durable work over total powered time
        # (resume + commit + soon-to-be-wasted work all charge the node)
        efficiency=useful_s / st.on_s if st.on_s > 0 else 0.0,
        inferences_per_day=st.committed * (DAY_S / trace.duration_s),
        dead=st.committed < 1.0,
        outage_frames=st.outages,
    )


def simulate_fleet(traces, configs) -> list[dict]:
    """Simulate each (trace, config) pair; pure and order-stable."""
    if len(traces) != len(configs):
        raise ValueError(f"got {len(traces)} traces but {len(configs)} "
                         f"node configs")
    return [simulate_node(tr, cfg) for tr, cfg in zip(traces, configs)]


def fleet_report(results, specs=None) -> dict:
    """Aggregate per-node stats into the fleet-level report (the
    ``bench_fleet.json`` currency): total inferences/day, mean
    forward-progress efficiency, dead-node count, per-archetype
    breakdown when the trace specs are supplied."""
    n = len(results)
    total_ipd = float(sum(r["inferences_per_day"] for r in results))
    dead = sum(1 for r in results if r["dead"])
    agg = dict(
        nodes=n,
        inferences_per_day=total_ipd,
        mean_efficiency=float(np.mean([r["efficiency"] for r in results]))
        if n else 0.0,
        dead_nodes=dead,
        failures=int(sum(r["failures"] for r in results)),
        harvested_j=float(sum(r["harvested_j"] for r in results)),
        consumed_j=float(sum(r["consumed_j"] for r in results)),
    )
    if specs is not None:
        by_arch: dict[str, list] = {}
        for spec, r in zip(specs, results):
            by_arch.setdefault(spec.archetype, []).append(r)
        agg["archetypes"] = {
            k: dict(nodes=len(rs),
                    inferences_per_day=float(
                        sum(r["inferences_per_day"] for r in rs)),
                    mean_efficiency=float(
                        np.mean([r["efficiency"] for r in rs])),
                    dead_nodes=sum(1 for r in rs if r["dead"]))
            for k, rs in sorted(by_arch.items())}
    return agg


# ---------------------------------------------------------------------------
# Discrete arm: engine-accounting replay + live validation
# ---------------------------------------------------------------------------

def outage_faultplan(outage_frames) -> FaultPlan:
    """A node's derived outage schedule as a live fault plan: power_loss
    at fixed work-clock instants (frames ~ logical decode steps).  The
    same JSON spec drives :func:`predict_engine_stats` and a real
    :class:`~repro.resilience.engine.ResilientServeEngine` — one failure
    model for simulated and live arms."""
    return FaultPlan.timeline([(t, POWER_LOSS) for t in outage_frames])


def rescale_outages(outage_frames, node_work_frames: float,
                    engine_work: float) -> list[float]:
    """Compress a node's outage schedule (work clock in frames, spanning a
    whole trace) onto a small engine replay's work-clock range, preserving
    the relative outage structure.  Both validation arms consume the SAME
    compressed timeline, so the compression factor never enters the
    simulator-vs-engine comparison — it only makes a day of node work
    replayable in seconds."""
    if node_work_frames <= 0:
        return []
    k = engine_work / node_work_frames
    return [t * k for t in outage_frames]


def epoch_schedule(new_tokens: int, epoch_steps: int) -> tuple:
    """Mirror of ``EpochLMRunner.epoch_schedule``."""
    n, k = new_tokens - 1, epoch_steps
    return tuple([k] * (n // k) + ([n % k] if n % k else []))


def predict_engine_stats(fault_spec, *, n_requests: int, new_tokens: int,
                         epoch_steps: int, max_batch: int) -> dict:
    """The simulator's accounting of what ``ResilientServeEngine`` will do
    under ``fault_spec`` (a ``FaultPlan`` JSON spec or instance).

    A step-exact mirror of the engine's hook sequence with checkpointing
    on: per attempt — staging poll (dt 0.25); prefill poll (dt 1.0) only
    when no checkpoint exists yet, commit after prefill; one decode poll
    per epoch (dt = steps), commit after each; a kill-class event requeues
    the bucket FIFO keeping its committed epoch.  Polls the same
    ``FaultPlan`` implementation the engine does, so fault times and
    offsets agree bit-for-bit.  Assumes no dead-letters (the validation
    arm runs the engine with a huge ``max_retries``) and no degrade
    (energy scale 1)."""
    faults = (fault_spec if isinstance(fault_spec, FaultPlan)
              else FaultPlan.from_json(fault_spec))
    schedule = epoch_schedule(new_tokens, epoch_steps)
    sizes = [max_batch] * (n_requests // max_batch)
    if n_requests % max_batch:
        sizes.append(n_requests % max_batch)
    # bucket state: [n_requests, committed_epoch or None (no checkpoint)]
    queue = deque([size, None] for size in sizes)
    s = dict(faults=0, power_losses=0, device_drops=0, slow_dispatches=0,
             staging_retries=0, retries=0, prefills=0, resumes=0, epochs=0,
             commits=0, executed_steps=0, useful_steps=0, wasted_steps=0.0,
             dispatches=0, requests=0)

    def _kill(ev, bucket, charge_offset: bool) -> bool:
        if ev is None:
            return False
        if ev.kind == SLOW_DISPATCH:
            s["slow_dispatches"] += 1
            return False
        if ev.kind == STAGING_CORRUPTION:
            s["staging_retries"] += 1
            return False
        s["faults"] += 1
        s["power_losses" if ev.kind == POWER_LOSS else "device_drops"] += 1
        if charge_offset:
            # only _fault_gate (prefill/decode) charges the partial window;
            # a staging kill raises from _stage_checked without it
            s["wasted_steps"] += ev.offset
        s["retries"] += bucket[0]
        queue.append(bucket)
        return True

    while queue:
        bucket = queue.popleft()
        if _kill(faults.poll("staging", dt=STAGING_DT), bucket,
                 charge_offset=False):
            continue
        if bucket[1] is None:
            if _kill(faults.poll("prefill", dt=PREFILL_DT), bucket,
                     charge_offset=True):
                continue
            s["prefills"] += 1
            s["commits"] += 1          # the epoch-0 (post-prefill) commit
            bucket[1] = 0
        else:
            s["resumes"] += 1
        killed = False
        for e in range(bucket[1], len(schedule)):
            steps = schedule[e]
            if _kill(faults.poll("decode", dt=float(steps)), bucket,
                     charge_offset=True):
                killed = True
                break
            s["executed_steps"] += steps
            s["epochs"] += 1
            s["commits"] += 1
            bucket[1] = e + 1
        if killed:
            continue
        s["useful_steps"] += sum(schedule)
        s["dispatches"] += 1
        s["requests"] += bucket[0]
    return s


def measured_efficiency(stats, nv_write_steps: float = 0.0) -> float:
    """Useful steps over total charged work — the same formula
    ``benchmarks/bench_resilience`` applies to live engine stats, usable
    on :func:`predict_engine_stats` output interchangeably."""
    restarts = max(0.0, stats["prefills"] + stats["resumes"]
                   - stats["dispatches"])
    total = (stats["executed_steps"] + stats["wasted_steps"] + restarts
             + nv_write_steps * stats["commits"])
    return stats["useful_steps"] / total if total else 0.0


# keys whose exact/tolerance match constitutes the validation contract
_VALIDATE_INT_KEYS = ("faults", "power_losses", "prefills", "resumes",
                      "epochs", "commits", "executed_steps", "useful_steps",
                      "dispatches", "requests", "retries")
_VALIDATE_FLOAT_KEYS = ("wasted_steps",)


def live_validation(outage_frames, *, checkpoint_dir, n_requests: int = 8,
                    new_tokens: int = 7, epoch_steps: int = 2,
                    max_batch: int = 4, prompt_len: int = 8,
                    tol: float = 1e-6, device="cuda") -> dict:
    """Replay one node's outage schedule through the port's REAL
    ``ResilientServeEngine`` (the reference's tiny smoke LM, W1A8, drawn
    by ``init_lm`` from ``torch.Generator`` seed 0 on ``device`` and
    prequantized: the port serves prequantized weights) and compare its
    measured stats against :func:`predict_engine_stats` on the same fault
    spec.  Its projections run the signed ``f32dot`` engine: cuBLASLt's
    int8 GEMM, the card's default signed engine, refuses this LM's
    K = 64 products, and the signed engines agree bit for bit.

    Validation contract: every integer work counter in
    ``_VALIDATE_INT_KEYS`` matches EXACTLY; float accounting
    (``wasted_steps`` and the derived ``measured_efficiency``) matches
    within ``tol`` (absolute).  Both arms poll the same
    ``FaultPlan.timeline`` JSON spec — one failure model, two executors.
    The counters depend on the schedule and the request geometry, not on
    the weights, so they equal the reference's ``live_validation`` on the
    same schedule.
    """
    import torch

    from repro_torch.configs import SINGLE, get_config
    from repro_torch.core.quant import PAPER_CONFIGS
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import prequantize_params
    from repro_torch.resilience import EpochLMRunner, ResilientServeEngine

    spec = outage_faultplan(outage_frames).to_json()
    cfg = dataclasses.replace(
        get_config("smollm-360m").smoke(
            n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
            vocab=64, head_dim=32),
        quant=dataclasses.replace(PAPER_CONFIGS["w1a8"], engine="f32dot"))
    device = torch.device(device)
    params = prequantize_params(T.init_lm(
        torch.Generator(device=device).manual_seed(0), cfg, SINGLE), cfg)
    prompts = [np.random.RandomState(i).randint(0, 64, size=(prompt_len,))
               .astype(np.int32) for i in range(n_requests)]
    runner = EpochLMRunner(params, cfg, new_tokens=new_tokens,
                           epoch_steps=epoch_steps)
    eng = ResilientServeEngine(runner, fault_plan=FaultPlan.from_json(spec),
                               checkpoint_dir=checkpoint_dir,
                               max_batch=max_batch, max_retries=10**9)
    results = eng.serve(prompts)
    predicted = predict_engine_stats(spec, n_requests=n_requests,
                                     new_tokens=new_tokens,
                                     epoch_steps=epoch_steps,
                                     max_batch=max_batch)
    measured = {k: eng.stats[k] for k in (*_VALIDATE_INT_KEYS,
                                          *_VALIDATE_FLOAT_KEYS)}
    deltas = {}
    ok = len(results) == n_requests and not eng.dead_letters
    for k in _VALIDATE_INT_KEYS:
        deltas[k] = int(measured[k]) - int(predicted[k])
        ok = ok and deltas[k] == 0
    for k in _VALIDATE_FLOAT_KEYS:
        deltas[k] = float(measured[k]) - float(predicted[k])
        ok = ok and abs(deltas[k]) <= tol
    eff_pred = measured_efficiency(predicted)
    eff_meas = measured_efficiency(measured)
    deltas["measured_efficiency"] = eff_meas - eff_pred
    ok = ok and abs(deltas["measured_efficiency"]) <= tol
    return dict(ok=bool(ok), tol=tol, fault_spec=spec, predicted=predicted,
                measured=measured, deltas=deltas,
                efficiency_predicted=eff_pred, efficiency_measured=eff_meas,
                completed=len(results), dead_letters=len(eng.dead_letters),
                device=str(device))


# DEVICE_DROP is imported for _kill's kind split but never drawn by
# timeline plans; referenced here so the shared-model contract is explicit
_KILL_KINDS = (POWER_LOSS, DEVICE_DROP)
