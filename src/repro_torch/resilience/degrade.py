"""Graceful degradation policy: trade bits for forward progress (port of
``repro/resilience/degrade.py``, a copy).

The paper's low bit-width operating points (W1A1 .. W1A8, Table/Fig. 5-6)
are not just an accuracy/energy dial — under intermittent power they are a
*survival* dial: a lower-bit plan moves fewer bytes and burns fewer pJ per
dispatch, so the same harvested-energy envelope completes more frames.
:class:`DegradePolicy` decides *when* the serving engine should take that
trade; :class:`repro_torch.resilience.engine.ResilientServeEngine`
executes it by swapping to the next pre-compiled fallback ``ModelPlan``
(already resident, so the swap is cheap and deterministic).

Two triggers, either sufficient:

* **fault pressure** — more than ``fault_threshold`` kill-class faults in
  the last ``fault_window`` dispatch outcomes (a brownout storm: the
  current operating point is too expensive for the incoming energy);
* **energy budget** — cumulative modeled dispatch energy (from the plan's
  per-layer ``cost`` annotations, summed in
  :func:`repro_torch.core.plan.plan_energy_pj`) exceeds ``energy_budget_pj``
  (the harvested-energy envelope of the paper's §II-B3 scenario).

The policy is deliberately memoryless across degrades: the engine calls
:meth:`reset` after each swap so the *new* operating point gets a fresh
window and budget before any further fallback.

Degradation is also reversible: when ``recover_after`` is set, a run of
that many consecutive fault-free dispatches at a degraded operating point
(``should_recover``) re-arms the **primary** plan — the brownout storm has
passed and the node claws back the accuracy it paid for survival.  The
engine resets the policy on recovery too, so a recovered node has to
re-earn any further degrade from a clean window.
"""
from __future__ import annotations

import dataclasses
from collections import deque


@dataclasses.dataclass
class DegradePolicy:
    """Sliding-window fault counter + cumulative energy budget."""

    fault_window: int = 8          # dispatch outcomes remembered
    fault_threshold: int = 3       # kill-class faults in window that trigger
    energy_budget_pj: float | None = None   # None = no energy trigger
    recover_after: int | None = None   # clean dispatches that re-arm primary
                                       # (None = degrades are one-way)

    def __post_init__(self):
        if self.fault_window < 1:
            raise ValueError(f"fault_window must be >= 1, "
                             f"got {self.fault_window}")
        if self.fault_threshold < 1:
            raise ValueError(f"fault_threshold must be >= 1, "
                             f"got {self.fault_threshold}")
        if self.energy_budget_pj is not None and self.energy_budget_pj <= 0:
            raise ValueError(f"energy_budget_pj must be positive or None, "
                             f"got {self.energy_budget_pj}")
        if self.recover_after is not None and self.recover_after < 1:
            raise ValueError(f"recover_after must be >= 1 or None, "
                             f"got {self.recover_after}")
        self._window: deque[int] = deque(maxlen=self.fault_window)
        self._energy_pj = 0.0
        self._clean_streak = 0

    # -- observations --------------------------------------------------------

    def record_fault(self) -> None:
        """One kill-class fault (power loss / device drop) happened."""
        self._window.append(1)
        self._clean_streak = 0

    def record_dispatch(self, energy_pj: float = 0.0) -> None:
        """One dispatch completed, spending ``energy_pj`` modeled energy."""
        self._window.append(0)
        self._energy_pj += float(energy_pj)
        self._clean_streak += 1

    # -- decision ------------------------------------------------------------

    @property
    def spent_pj(self) -> float:
        return self._energy_pj

    def fault_pressure(self) -> int:
        return sum(self._window)

    def clean_streak(self) -> int:
        return self._clean_streak

    def should_degrade(self) -> bool:
        if self.fault_pressure() >= self.fault_threshold:
            return True
        return (self.energy_budget_pj is not None
                and self._energy_pj >= self.energy_budget_pj)

    def should_recover(self) -> bool:
        """Fault pressure has subsided: ``recover_after`` consecutive clean
        dispatches since the last kill-class fault (or reset)."""
        return (self.recover_after is not None
                and self._clean_streak >= self.recover_after)

    def reset(self) -> None:
        """Fresh window, budget, and streak for the new operating point."""
        self._window.clear()
        self._energy_pj = 0.0
        self._clean_streak = 0
