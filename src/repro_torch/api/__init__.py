"""Public surface of the port: build -> compile -> forward / serve /
simulate / save, ``load``, the paper's report tables
(:mod:`repro_torch.api.reports`) and the fleet-scale intermittency entry
point (``api.fleet``: harvest traces, the fluid node simulator, per-node
plan co-design; it re-exports :mod:`repro_torch.fleet`)."""
from .session import (CompiledModel, CostReport, Deployment, Model, build,
                      load)
from .targets import (ComputeTarget, Cost, LayerGeometry, PIMTarget,
                      available_targets, get_target, target_for_backend)
from . import reports
from repro_torch import fleet
