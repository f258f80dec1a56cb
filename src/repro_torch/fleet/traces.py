"""Seeded energy-harvest trace generators (port of
``repro/fleet/traces.py``, a copy: numpy only).

A fleet of battery-less nodes is heterogeneous in exactly one input: the
power its harvester offers over the day.  This module turns a compact
:class:`TraceSpec` (archetype + seed + a few physical knobs) into a
:class:`HarvestTrace` — a piecewise-constant power-availability timeline in
mW — deterministically: the trace is a pure function of the spec, so a
fleet study replays bit-for-bit from the JSON'd specs alone and the
serialized form stays kilobytes even for thousands of day-long traces.

Three harvester archetypes (the usual energy-harvesting IoT trio):

``solar``    diurnal half-sine between sunrise and sunset, modulated by a
             smoothed cloud-attenuation process; zero at night.
``rf``       a low ambient floor plus Poisson bursts (a nearby transmitter
             duty-cycling): exponential inter-burst gaps, jittered burst
             length and amplitude.
``thermal``  steady harvest from a temperature gradient with slow AR(1)
             drift, interrupted by exponential dropouts (the gradient
             collapses — machinery off, sun leaves the hot plate).

Traces serialize spec-first: ``HarvestTrace.to_json()`` stores the spec and
(optionally) the samples; ``from_json`` regenerates from the spec when the
samples were not embedded and verifies length when they were.
"""
from __future__ import annotations

import dataclasses

import numpy as np

ARCHETYPES = ("solar", "rf", "thermal")

DAY_S = 86400.0


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Everything needed to regenerate one node's harvest timeline."""

    node_id: str
    archetype: str
    seed: int
    dt_s: float = 60.0            # sample period (piecewise-constant power)
    duration_s: float = DAY_S
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.archetype not in ARCHETYPES:
            raise ValueError(f"unknown archetype {self.archetype!r}; "
                             f"valid: {ARCHETYPES}")
        if self.dt_s <= 0 or self.duration_s <= 0:
            raise ValueError(f"dt_s and duration_s must be positive, got "
                             f"dt_s={self.dt_s} duration_s={self.duration_s}")
        if self.duration_s < self.dt_s:
            raise ValueError(f"duration_s ({self.duration_s}) must cover at "
                             f"least one sample (dt_s={self.dt_s})")

    @property
    def n_samples(self) -> int:
        return int(round(self.duration_s / self.dt_s))

    def to_json(self) -> dict:
        return dict(node_id=self.node_id, archetype=self.archetype,
                    seed=self.seed, dt_s=self.dt_s,
                    duration_s=self.duration_s, params=dict(self.params))

    @classmethod
    def from_json(cls, d: dict) -> "TraceSpec":
        return cls(node_id=d["node_id"], archetype=d["archetype"],
                   seed=int(d["seed"]), dt_s=float(d["dt_s"]),
                   duration_s=float(d["duration_s"]),
                   params=dict(d.get("params") or {}))


@dataclasses.dataclass(frozen=True)
class HarvestTrace:
    """A spec plus its realized power timeline (mW per ``dt_s`` sample)."""

    spec: TraceSpec
    power_mw: np.ndarray

    @property
    def dt_s(self) -> float:
        return self.spec.dt_s

    @property
    def duration_s(self) -> float:
        return self.spec.duration_s

    def harvested_j(self) -> float:
        """Total energy the harvester offers over the trace, in joules."""
        return float(self.power_mw.sum()) * self.dt_s * 1e-3

    def to_json(self, embed_power: bool = False) -> dict:
        d = dict(version=1, spec=self.spec.to_json())
        if embed_power:
            d["power_mw"] = [float(p) for p in self.power_mw]
        return d

    @classmethod
    def from_json(cls, d: dict) -> "HarvestTrace":
        spec = TraceSpec.from_json(d["spec"])
        if "power_mw" in d:
            power = np.asarray(d["power_mw"], float)
            if power.shape != (spec.n_samples,):
                raise ValueError(
                    f"embedded power length {power.shape} does not match "
                    f"spec ({spec.n_samples} samples)")
            return cls(spec, power)
        return make_trace(spec)


# ---------------------------------------------------------------------------
# Generators — each a pure function of (spec.seed, spec.params)
# ---------------------------------------------------------------------------

def _ar1(rng: np.random.RandomState, n: int, tau_samples: float) -> np.ndarray:
    """Smoothed noise in [0, 1]: an AR(1) walk with correlation time
    ``tau_samples``, squashed through a logistic.  Gives clouds/drift their
    slow structure without any FFT machinery."""
    rho = float(np.exp(-1.0 / max(tau_samples, 1e-9)))
    innov = rng.normal(size=n) * np.sqrt(max(1.0 - rho * rho, 1e-12))
    x = np.empty(n)
    acc = rng.normal()
    for i in range(n):
        acc = rho * acc + innov[i]
        x[i] = acc
    return 1.0 / (1.0 + np.exp(-1.5 * x))


def _solar(spec: TraceSpec) -> np.ndarray:
    p = spec.params
    peak_mw = float(p.get("peak_mw", 120.0))
    sunrise_s = float(p.get("sunrise_s", 6 * 3600.0))
    sunset_s = float(p.get("sunset_s", 18 * 3600.0))
    cloud_depth = float(p.get("cloud_depth", 0.6))     # worst-case attenuation
    cloud_tau_s = float(p.get("cloud_tau_s", 1800.0))  # cloud correlation time
    if sunset_s <= sunrise_s:
        raise ValueError(f"sunset_s ({sunset_s}) must be after "
                         f"sunrise_s ({sunrise_s})")
    rng = np.random.RandomState(spec.seed)
    n = spec.n_samples
    t = (np.arange(n) + 0.5) * spec.dt_s
    tod = t % DAY_S                      # multi-day traces repeat the diurnal
    phase = (tod - sunrise_s) / (sunset_s - sunrise_s)
    day = np.where((phase > 0) & (phase < 1), np.sin(np.pi * phase), 0.0)
    clouds = 1.0 - cloud_depth * _ar1(rng, n, cloud_tau_s / spec.dt_s)
    return peak_mw * day * clouds


def _rf(spec: TraceSpec) -> np.ndarray:
    p = spec.params
    floor_mw = float(p.get("floor_mw", 1.0))
    burst_mw = float(p.get("burst_mw", 150.0))
    gap_s = float(p.get("mean_gap_s", 600.0))       # mean gap between bursts
    burst_s = float(p.get("mean_burst_s", 90.0))    # mean burst length
    rng = np.random.RandomState(spec.seed)
    n = spec.n_samples
    power = np.full(n, floor_mw)
    t = rng.exponential(gap_s)
    while t < spec.duration_s:
        width = rng.exponential(burst_s)
        amp = burst_mw * rng.uniform(0.5, 1.5)
        i0 = int(t / spec.dt_s)
        i1 = max(i0 + 1, int(np.ceil((t + width) / spec.dt_s)))
        power[i0:min(i1, n)] += amp
        t += width + rng.exponential(gap_s)
    return power


def _thermal(spec: TraceSpec) -> np.ndarray:
    p = spec.params
    level_mw = float(p.get("level_mw", 40.0))
    drift = float(p.get("drift", 0.3))              # relative AR(1) wander
    drift_tau_s = float(p.get("drift_tau_s", 7200.0))
    gap_s = float(p.get("mean_gap_s", 4 * 3600.0))  # mean time between drops
    drop_s = float(p.get("mean_drop_s", 1200.0))    # mean dropout length
    rng = np.random.RandomState(spec.seed)
    n = spec.n_samples
    wander = 1.0 - drift + 2 * drift * _ar1(rng, n, drift_tau_s / spec.dt_s)
    power = level_mw * wander
    t = rng.exponential(gap_s)
    while t < spec.duration_s:
        width = rng.exponential(drop_s)
        i0 = int(t / spec.dt_s)
        i1 = max(i0 + 1, int(np.ceil((t + width) / spec.dt_s)))
        power[i0:min(i1, n)] = 0.0
        t += width + rng.exponential(gap_s)
    return power


_GENERATORS = {"solar": _solar, "rf": _rf, "thermal": _thermal}


def make_trace(spec: TraceSpec) -> HarvestTrace:
    """Realize a spec.  Pure: same spec -> bit-identical timeline."""
    power = _GENERATORS[spec.archetype](spec)
    return HarvestTrace(spec, np.maximum(power, 0.0))


# ---------------------------------------------------------------------------
# Fleet generation
# ---------------------------------------------------------------------------

DEFAULT_MIX = (("solar", 0.5), ("rf", 0.3), ("thermal", 0.2))


def generate_fleet(n_nodes: int, seed: int = 0,
                   mix=DEFAULT_MIX, dt_s: float = 60.0,
                   duration_s: float = DAY_S) -> list[TraceSpec]:
    """Draw ``n_nodes`` heterogeneous trace specs from one master seed.

    Per-node heterogeneity: the archetype (drawn from ``mix``), the
    archetype's physical knobs (panel size, transmitter distance, gradient
    strength, ...) and the child seed all come from one ``RandomState``,
    so the whole fleet is a pure function of ``(n_nodes, seed, mix)`` and
    specs stay stable under fleet-size growth (node i's spec never depends
    on n_nodes).
    """
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    kinds = [k for k, _ in mix]
    probs = np.asarray([w for _, w in mix], float)
    if (probs < 0).any() or probs.sum() <= 0:
        raise ValueError(f"mix weights must be non-negative and sum > 0, "
                         f"got {mix}")
    probs = probs / probs.sum()
    master = np.random.RandomState(seed)
    specs = []
    for i in range(n_nodes):
        kind = kinds[int(master.choice(len(kinds), p=probs))]
        child_seed = int(master.randint(0, 2**31 - 1))
        if kind == "solar":
            params = dict(
                peak_mw=float(master.uniform(40.0, 240.0)),
                sunrise_s=float(master.uniform(5.0, 7.0) * 3600),
                sunset_s=float(master.uniform(17.0, 19.0) * 3600),
                cloud_depth=float(master.uniform(0.2, 0.8)))
        elif kind == "rf":
            params = dict(
                floor_mw=float(master.uniform(0.2, 3.0)),
                burst_mw=float(master.uniform(60.0, 300.0)),
                mean_gap_s=float(master.uniform(180.0, 1200.0)),
                mean_burst_s=float(master.uniform(30.0, 240.0)))
        else:
            params = dict(
                level_mw=float(master.uniform(10.0, 80.0)),
                drift=float(master.uniform(0.1, 0.5)),
                mean_gap_s=float(master.uniform(2.0, 8.0) * 3600),
                mean_drop_s=float(master.uniform(300.0, 2400.0)))
        specs.append(TraceSpec(node_id=f"node{i:05d}", archetype=kind,
                               seed=child_seed, dt_s=dt_s,
                               duration_s=duration_s, params=params))
    return specs
