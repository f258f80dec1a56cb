"""Executable intermittency resilience (port of ``repro/resilience``).

Makes the paper's power-intermittency claim (§II-B3, Fig. 7) a property of
the running serve stack:

* :class:`FaultPlan` — seeded deterministic fault schedules (power loss,
  device drop, slow dispatch, staging corruption) on a logical work clock;
* :class:`DecodeCheckpointer` — crash-consistent K-step decode epoch
  checkpoints through the atomic ``train.checkpoint.Checkpointer``;
* :class:`ResilientServeEngine` / :class:`EpochLMRunner` — a ServeEngine
  that survives the schedule: idempotent re-enqueue, bounded backoff
  retries, deadlines, dead letters;
* :class:`DegradePolicy` — fall back to a pre-compiled lower-bit plan
  under fault pressure or an energy budget.

Entry points: construct the pieces directly, or, for a CNN plan, through
the facade::

    compiled = api.build(spec, W1A8, params=p).compile(batch_hints=(1, 8))
    dep = compiled.serve(resilience=ResilienceConfig(
        fault_plan=FaultPlan(mtbf=32.0, seed=0),
        degrade=DegradePolicy(fault_threshold=2)), fallback=w1a1_compiled)

An LM engine is built directly, ``ResilientServeEngine(EpochLMRunner(
params, cfg, new_tokens=..., epoch_steps=4), checkpoint_dir=...)``: the
facade's LM branch needs LM plans, which are not yet ported.
"""
from __future__ import annotations

import dataclasses

from .checkpoints import DecodeCheckpointer
from .degrade import DegradePolicy
from .engine import EpochLMRunner, ResilientServeEngine
from .faults import (DEVICE_DROP, POWER_LOSS, SITE_KINDS, SLOW_DISPATCH,
                     STAGING_CORRUPTION, DeviceDrop, FaultError, FaultEvent,
                     FaultPlan, PowerLoss)

__all__ = [
    "FaultPlan", "FaultEvent", "FaultError", "PowerLoss", "DeviceDrop",
    "POWER_LOSS", "DEVICE_DROP", "SLOW_DISPATCH", "STAGING_CORRUPTION",
    "SITE_KINDS", "DecodeCheckpointer", "DegradePolicy", "EpochLMRunner",
    "ResilientServeEngine", "ResilienceConfig", "build_resilient_engine",
]


@dataclasses.dataclass
class ResilienceConfig:
    """Everything the facade needs to stand up a resilient engine."""

    fault_plan: FaultPlan | None = None     # None = fault-free reference arm
    checkpoint_dir: str | None = None       # None = volatile (P=0) baseline
    epoch_steps: int = 4                    # checkpoint period K (paper's P)
    max_retries: int = 3
    deadline_s: float | None = None
    backoff_base_s: float = 0.01
    backoff_max_s: float = 1.0
    degrade: DegradePolicy | None = None


def build_resilient_engine(compiled, config: ResilienceConfig, *,
                           fallback=None, **engine_kw) -> ResilientServeEngine:
    """Resilient engine over a CNN :class:`repro_torch.api.session.
    CompiledModel`.  ``fallback`` is another CompiledModel (same network,
    lower bit width) compiled ahead of time; with ``config.degrade`` set,
    the engine swaps to it under fault pressure or a spent energy
    budget."""
    from repro_torch.core.plan import PlanError
    from repro_torch.launch.engine import CNNRunner

    def _runner(c):
        if c.plan.kind != "cnn":
            raise PlanError(
                f"resilient serving through the facade takes CNN plans "
                f"(got {c.plan.kind!r}); for an LM build "
                "ResilientServeEngine(EpochLMRunner(params, cfg, ...)) "
                "directly: LM plans are not yet ported")
        return CNNRunner(c.plan)

    fallbacks = () if fallback is None else (_runner(fallback),)
    return ResilientServeEngine(
        _runner(compiled),
        fault_plan=config.fault_plan,
        checkpoint_dir=config.checkpoint_dir,
        max_retries=config.max_retries,
        deadline_s=config.deadline_s,
        backoff_base_s=config.backoff_base_s,
        backoff_max_s=config.backoff_max_s,
        degrade=config.degrade,
        fallbacks=fallbacks,
        **engine_kw)
