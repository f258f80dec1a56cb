"""Public surface of the port: build -> compile -> forward/serve/simulate."""
from .session import CompiledModel, CostReport, Deployment, Model, build
from .targets import available_targets, get_target
