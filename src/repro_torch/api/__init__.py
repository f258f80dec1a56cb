"""Public surface of the port: build -> compile -> forward / serve /
simulate / save, ``load``, and the paper's report tables
(:mod:`repro_torch.api.reports`)."""
from .session import (CompiledModel, CostReport, Deployment, Model, build,
                      load)
from .targets import (ComputeTarget, Cost, LayerGeometry, PIMTarget,
                      available_targets, get_target, target_for_backend)
from . import reports
