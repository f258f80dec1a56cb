"""Deterministic fault injection for the live serve path (port of
``repro/resilience/faults.py``, a copy with the same numpy draws, so a
seed gives the reference's event log).

The paper's second headline claim is power-intermittency resilience: a
battery-less node keeps making forward progress because the partial state
it needs lives in non-volatile elements (§II-B3, Fig. 7).  The analytic
side of that claim is ``pim/intermittent.forward_progress``; this module
supplies the *executable* side — a seeded, reproducible schedule of fault
events that :class:`repro_torch.resilience.engine.ResilientServeEngine`
and ``launch/engine.ContinuousLMEngine`` poll at
its hook points (staging, prefill, each decode epoch, single-shot
dispatch).

Faults are drawn on a **logical work clock** measured in decode steps, not
wall time: every hook advances the clock by the amount of work it is about
to attempt (``dt``), and a fault fires when the pre-drawn exponential
schedule (mean ``mtbf`` steps — the MTBF of the paper's Fig. 7, in frames)
lands inside that window.  Logical time makes a chaos run a pure function
of ``(seed, mtbf, submit order)``: the bit-identity tests replay the exact
same kill points on every host, and the measured forward-progress
efficiency maps onto the analytic model without wall-clock noise.

Event kinds and who may draw them:

=====================  =====================================================
``power_loss``         the node browns out: everything volatile in the
                       current dispatch is lost (any site)
``device_drop``        the accelerator disappears mid-dispatch; host state
                       survives (prefill/decode/dispatch)
``slow_dispatch``      the dispatch stalls (brownout throttling) — latency
                       only, no state loss (prefill/decode/dispatch)
``staging_corruption`` the host->device copy is corrupted; detected by
                       checksum and restaged (staging only)
=====================  =====================================================
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

POWER_LOSS = "power_loss"
DEVICE_DROP = "device_drop"
SLOW_DISPATCH = "slow_dispatch"
STAGING_CORRUPTION = "staging_corruption"

KINDS = (POWER_LOSS, DEVICE_DROP, SLOW_DISPATCH, STAGING_CORRUPTION)

# which kinds are physically meaningful at each hook site: a corrupted
# host->device copy can only be observed while staging; a lost device or a
# stalled program only while a program is (about to be) in flight
SITE_KINDS = {
    "staging": (POWER_LOSS, STAGING_CORRUPTION),
    "prefill": (POWER_LOSS, DEVICE_DROP, SLOW_DISPATCH),
    "decode": (POWER_LOSS, DEVICE_DROP, SLOW_DISPATCH),
    "dispatch": (POWER_LOSS, DEVICE_DROP, SLOW_DISPATCH),
}

DEFAULT_WEIGHTS = {POWER_LOSS: 0.6, DEVICE_DROP: 0.2,
                   SLOW_DISPATCH: 0.1, STAGING_CORRUPTION: 0.1}


class FaultError(RuntimeError):
    """A fault event realized as an exception; ``.event`` holds it."""

    def __init__(self, event: "FaultEvent"):
        super().__init__(f"{event.kind} at {event.site} (t={event.t:.2f})")
        self.event = event


class PowerLoss(FaultError):
    """Power failed: all volatile state in the current dispatch is gone."""


class DeviceDrop(FaultError):
    """The device vanished mid-dispatch; host-side state survives."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str
    site: str
    t: float          # logical work-clock time at which the fault fired
    offset: float     # how far into this hook's dt window it landed
    seq: int          # firing order (0-based)


class FaultPlan:
    """A seeded, deterministic schedule of fault events.

    Three construction modes:

    * ``FaultPlan(mtbf, seed=..)`` — random schedule: inter-fault gaps are
      exponential with mean ``mtbf`` logical steps; the kind of each fault
      is drawn from ``weights`` restricted to what is meaningful at the
      site that happens to be polling (:data:`SITE_KINDS`).  Same seed +
      same poll sequence -> same events, always.
    * ``FaultPlan.scripted([(site, n, kind), ..])`` — fire ``kind`` at the
      ``n``-th poll of ``site`` (0-based, counted per site).  This is the
      test surface: "kill the first prefill", "corrupt the second staging"
      are one tuple each, with no RNG in the way.
    * ``FaultPlan.timeline([(t, kind), ..])`` — fire ``kind`` at fixed
      work-clock times, whichever site happens to be polling when the
      clock reaches ``t``.  This is how an energy-harvest trace becomes a
      live fault schedule (outage instants derived from the trace).
      Only site-universal kinds
      (``power_loss``) are allowed — a timeline does not know which site
      will observe it.

    Modes compose (scripted events take precedence, then timeline, then
    random); :meth:`to_json`/:meth:`from_json` round-trip the construction
    spec: one on-disk format for every schedule, the reference's.  ``FaultPlan(None)`` never fires — the fault-free reference
    arm of every bit-identity assertion runs the identical code path.
    """

    def __init__(self, mtbf: float | None, *, seed: int = 0,
                 weights: dict | None = None):
        if mtbf is not None and mtbf <= 0:
            raise ValueError(f"mtbf must be positive (logical decode steps) "
                             f"or None for no random faults, got {mtbf}")
        self.mtbf = mtbf
        self.seed = int(seed)
        self.weights = dict(weights or DEFAULT_WEIGHTS)
        unknown = set(self.weights) - set(KINDS)
        if unknown:
            raise ValueError(f"unknown fault kinds {sorted(unknown)}; "
                             f"valid: {list(KINDS)}")
        self._rng = np.random.RandomState(seed)
        self._t = 0.0
        self._next = (self._t + self._rng.exponential(mtbf)
                      if mtbf is not None else float("inf"))
        self._scripted: dict[tuple[str, int], str] = {}
        self._timeline: list[tuple[float, str]] = []
        self._timeline_idx = 0
        self._site_calls: dict[str, int] = {}
        self.log: list[FaultEvent] = []

    @classmethod
    def scripted(cls, events) -> "FaultPlan":
        """``events``: iterable of ``(site, nth_poll_of_site, kind)``."""
        plan = cls(None)
        for site, n, kind in events:
            if site not in SITE_KINDS:
                raise ValueError(f"unknown site {site!r}; "
                                 f"valid: {sorted(SITE_KINDS)}")
            if kind not in SITE_KINDS[site]:
                raise ValueError(f"kind {kind!r} cannot fire at {site!r} "
                                 f"(allowed: {SITE_KINDS[site]})")
            plan._scripted[(site, int(n))] = kind
        return plan

    @classmethod
    def timeline(cls, events) -> "FaultPlan":
        """``events``: iterable of ``(work_clock_t, kind)``, non-decreasing
        ``t >= 0``.  Each event fires inside the first poll whose window
        reaches ``t`` (the clock stops at the event, like random mode)."""
        universal = set(KINDS)
        for kinds in SITE_KINDS.values():
            universal &= set(kinds)
        plan = cls(None)
        prev = 0.0
        for t, kind in events:
            t = float(t)
            if t < 0:
                raise ValueError(f"timeline t must be >= 0, got {t}")
            if t < prev:
                raise ValueError(f"timeline times must be non-decreasing "
                                 f"(got {t} after {prev})")
            if kind not in universal:
                raise ValueError(
                    f"kind {kind!r} is not valid at every site (a timeline "
                    f"does not know which site observes it); allowed: "
                    f"{sorted(universal)}")
            plan._timeline.append((t, kind))
            prev = t
        return plan

    # -- serialization ---------------------------------------------------------

    def to_json(self) -> dict:
        """The *construction* spec (not mid-run polling state): feeding the
        result to :meth:`from_json` yields a fresh, equivalent plan."""
        return dict(
            version=1,
            mtbf=self.mtbf,
            seed=self.seed,
            weights=dict(self.weights),
            scripted=[[site, n, kind]
                      for (site, n), kind in sorted(self._scripted.items())],
            timeline=[[t, kind] for t, kind in self._timeline],
        )

    @classmethod
    def from_json(cls, spec: dict) -> "FaultPlan":
        version = spec.get("version", 1)
        if version != 1:
            raise ValueError(f"unknown FaultPlan spec version {version!r}")
        plan = cls(spec.get("mtbf"), seed=spec.get("seed", 0),
                   weights=spec.get("weights") or None)
        if spec.get("scripted"):
            scripted = cls.scripted(spec["scripted"])
            plan._scripted = scripted._scripted
        if spec.get("timeline"):
            timeline = cls.timeline(spec["timeline"])
            plan._timeline = timeline._timeline
        return plan

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))

    # -- polling -------------------------------------------------------------

    def poll(self, site: str, dt: float = 1.0):
        """Advance the work clock by ``dt`` for one hook at ``site``.

        Returns the :class:`FaultEvent` that fires inside this window, or
        None.  At most one event fires per poll: once the node is down the
        rest of the window never executes, so the clock stops at the fault
        and the next inter-fault gap is drawn from there.
        """
        n = self._site_calls.get(site, 0)
        self._site_calls[site] = n + 1
        kind = self._scripted.get((site, n))
        if kind is not None:
            ev = FaultEvent(kind, site, self._t, 0.0, len(self.log))
            self.log.append(ev)
            return ev
        end = self._t + dt
        if self._timeline_idx < len(self._timeline):
            ft, tkind = self._timeline[self._timeline_idx]
            if ft <= end:
                self._timeline_idx += 1
                offset = max(0.0, ft - self._t)
                self._t = max(self._t, ft)
                ev = FaultEvent(tkind, site, self._t, offset, len(self.log))
                self.log.append(ev)
                return ev
        if self._next <= end:
            ft = self._next
            offset = ft - self._t
            self._t = ft
            self._next = ft + self._rng.exponential(self.mtbf)
            ev = FaultEvent(self._draw_kind(site), site, ft, offset,
                            len(self.log))
            self.log.append(ev)
            return ev
        self._t = end
        return None

    def _draw_kind(self, site: str) -> str:
        allowed = [k for k in SITE_KINDS.get(site, KINDS)
                   if self.weights.get(k, 0.0) > 0.0]
        if not allowed:
            return POWER_LOSS
        w = np.asarray([self.weights[k] for k in allowed], float)
        return allowed[int(self._rng.choice(len(allowed), p=w / w.sum()))]

    # -- realization ---------------------------------------------------------

    @staticmethod
    def raise_for(event: FaultEvent) -> None:
        """Turn a kill-class event into its exception (the engine's hook
        helper); latency/corruption kinds are handled in place, not raised."""
        if event.kind == POWER_LOSS:
            raise PowerLoss(event)
        if event.kind == DEVICE_DROP:
            raise DeviceDrop(event)
