"""Power-intermittency simulation (paper §II-B3, Fig. 7; port of
``repro/pim/intermittent.py``, a copy with the same numpy draws).

Models a battery-less node computing frame-by-frame under random power
failures (exponential MTBF).  With NV-FA retention (checkpoint period P
frames), a failure loses only the work since the last NV write plus the
in-flight adds (~(m+n)*58 ps — negligible); without it (P=0), a failure
restarts the whole current frame sequence (volatile accumulators).
"""
from __future__ import annotations


import numpy as np

from repro_torch.core.compressor import NVFATiming


def forward_progress(n_frames: int, frame_time_us: float, mtbf_us: float,
                     checkpoint_period_frames: int, nv_write_us: float = 1.0,
                     m_bits: int = 1, n_bits: int = 8, seed: int = 0,
                     resume_us: float = 0.0) -> dict:
    """Simulate until n_frames complete; returns progress statistics.

    checkpoint_period_frames = 0 -> no NV retention (volatile baseline):
    a power failure discards ALL frames since the sequence start.

    ``resume_us`` models the RESTART overhead paid after every power
    failure before the first post-failure frame can run — the software
    analogue of re-deriving the execution mapping.  A node without a
    persisted ModelPlan re-quantizes weights and re-runs engine
    selection (large ``resume_us``); a node with
    a plan on disk (``core/plan.save_plan``) just reloads it (small).
    :func:`plan_resume_study` sweeps exactly this comparison.
    """
    # validate before the simulation loop: mtbf_us <= 0 would make every
    # exponential draw zero (an infinite failure loop inside the budget),
    # and the others silently return nonsense statistics
    if n_frames <= 0:
        raise ValueError(f"n_frames must be positive, got {n_frames}")
    if frame_time_us <= 0:
        raise ValueError(f"frame_time_us must be positive, "
                         f"got {frame_time_us}")
    if mtbf_us <= 0:
        raise ValueError(f"mtbf_us must be positive, got {mtbf_us}")
    if checkpoint_period_frames < 0:
        raise ValueError(f"checkpoint_period_frames must be >= 0 "
                         f"(0 = volatile), got {checkpoint_period_frames}")
    if nv_write_us < 0:
        raise ValueError(f"nv_write_us must be >= 0, got {nv_write_us}")
    if resume_us < 0:
        raise ValueError(f"resume_us must be >= 0, got {resume_us}")
    rng = np.random.RandomState(seed)
    t = 0.0
    committed = 0          # frames durably retained
    in_flight = 0          # frames since last NV write
    failures = 0
    wasted_us = 0.0
    budget_us = n_frames * frame_time_us * 50  # hard stop
    nvfa = NVFATiming()
    while committed + in_flight < n_frames and t < budget_us:
        next_fail = rng.exponential(mtbf_us)
        frame_cost = frame_time_us
        if checkpoint_period_frames and (in_flight + 1) % checkpoint_period_frames == 0:
            frame_cost += nv_write_us
        if next_fail < frame_cost:
            # power lost mid-frame: lose in-flight work (plus the current
            # frame), then pay the restart/replan overhead — which runs on
            # the SAME failure-prone supply, so a long replan can itself be
            # interrupted and must restart from scratch (this compounding
            # is exactly why persisting the plan matters)
            failures += 1
            lost = in_flight if checkpoint_period_frames else committed + in_flight
            wasted_us += lost * frame_time_us + next_fail
            t += next_fail
            while resume_us > 0.0 and t < budget_us:
                resume_fail = rng.exponential(mtbf_us)
                if resume_fail >= resume_us:
                    t += resume_us
                    wasted_us += resume_us
                    break
                failures += 1
                t += resume_fail
                wasted_us += resume_fail
            if checkpoint_period_frames:
                in_flight = 0
            else:
                committed, in_flight = 0, 0
            continue
        t += frame_cost
        in_flight += 1
        if checkpoint_period_frames and in_flight >= checkpoint_period_frames:
            committed += in_flight
            in_flight = 0
    # Frames surviving at the end: if the sequence COMPLETED, the volatile
    # tail is read out while still powered and counts.  If the budget_us
    # hard-stop fired, only NV-committed frames are durable — volatile
    # in_flight work dies with the next power cycle, and counting it would
    # overstate the no-retention (P=0) baseline, which keeps *everything*
    # volatile until the sequence end.
    finished = committed + in_flight >= n_frames
    done = min(committed + in_flight, n_frames) if finished else committed
    useful_us = done * frame_time_us
    return dict(
        completed_frames=int(done),
        failures=failures,
        total_time_us=t,
        wasted_us=wasted_us,
        efficiency=useful_us / t if t else 0.0,
        vulnerable_window_ps=nvfa.vulnerable_window_ps(m_bits, n_bits),
    )


def _study_rng(seed, rng) -> np.random.RandomState:
    """One RNG discipline for every multi-draw study: an explicit
    ``RandomState`` wins, else a fresh one from ``seed`` — never ambient
    global state, so every study is a pure function of its arguments."""
    if rng is not None:
        if not isinstance(rng, np.random.RandomState):
            raise TypeError(f"rng must be a numpy RandomState, "
                            f"got {type(rng).__name__}")
        return rng
    return np.random.RandomState(seed)


def _aggregate(runs: list[dict]) -> dict:
    """Mean ± 95% CI over repeated simulations.  Keeps the single-draw key
    names (``efficiency``, ``completed_frames``, ``failures``, ...) as the
    means so existing table/benchmark consumers read the same fields."""
    out: dict = {}
    n = len(runs)
    for key in ("completed_frames", "failures", "total_time_us",
                "wasted_us", "efficiency"):
        vals = np.asarray([r[key] for r in runs], float)
        out[key] = float(vals.mean())
        # normal-approximation 95% CI half-width; 0 for a single draw
        out[key + "_ci95"] = float(1.96 * vals.std(ddof=1) / np.sqrt(n)
                                   if n > 1 else 0.0)
    out["repeats"] = n
    out["vulnerable_window_ps"] = runs[0]["vulnerable_window_ps"]
    return out


def sweep_checkpoint_period(periods=(0, 1, 2, 5, 10, 20, 50),
                            mtbf_us: float = 500.0, n_frames: int = 500,
                            frame_time_us: float = 100.0, seed: int = 0,
                            repeats: int = 8, rng=None) -> dict[int, dict]:
    """Fig.-7-style study: efficiency vs NV write period (20 frames is the
    paper's default; higher periods trade resilience for write energy).

    Each period is simulated ``repeats`` times on seeds drawn from one
    explicit RNG (``seed`` or a caller-supplied ``rng``); every reported
    statistic is a mean with a ``*_ci95`` half-width alongside.
    """
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    r = _study_rng(seed, rng)
    # one seed block per period, drawn up front so adding a period never
    # perturbs the seeds of the ones before it
    seeds = {p: r.randint(0, 2**31 - 1, size=repeats) for p in periods}
    return {p: _aggregate([forward_progress(n_frames, frame_time_us,
                                            mtbf_us, p, seed=int(s))
                           for s in seeds[p]])
            for p in periods}


def plan_resume_study(compile_us: float, plan_load_us: float,
                      checkpoint_period_frames: int = 20,
                      mtbf_us: float = 500.0, n_frames: int = 500,
                      frame_time_us: float = 100.0, seed: int = 0,
                      repeats: int = 16, rng=None) -> dict:
    """Restart-cost study: persisted ModelPlan vs full replan per failure.

    The paper's node resumes instantly because its execution mapping lives
    in non-volatile sub-arrays; our software analogue only matches that
    when the compiled plan (prequantized levels + engine verdicts) is on
    disk.  ``compile_us`` is the measured cold compile cost,
    ``plan_load_us`` the measured ``load_plan`` cost (``chip_smoke.py``
    measures both on the card).

    The study is ``repeats`` paired simulations: each repeat draws one
    failure seed from an explicit RNG (``seed`` or ``rng``) and runs BOTH
    arms on it, so the per-pair delta is purely the resume overhead.
    Reported efficiencies are means with 95% CIs (``efficiency_ci95``);
    ``efficiency_gain`` is the ratio of the arm means.
    """
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    r = _study_rng(seed, rng)
    pair_seeds = [int(s) for s in r.randint(0, 2**31 - 1, size=repeats)]
    kw = dict(n_frames=n_frames, frame_time_us=frame_time_us,
              mtbf_us=mtbf_us,
              checkpoint_period_frames=checkpoint_period_frames)
    recompile = _aggregate([forward_progress(resume_us=compile_us, seed=s,
                                             **kw) for s in pair_seeds])
    reload_ = _aggregate([forward_progress(resume_us=plan_load_us, seed=s,
                                           **kw) for s in pair_seeds])
    return dict(
        recompile=recompile, plan_reload=reload_,
        efficiency_gain=(reload_["efficiency"]
                         / max(recompile["efficiency"], 1e-12)))
