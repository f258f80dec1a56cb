"""Fleet-scale intermittency simulation + per-node plan co-design (port
of ``repro/fleet``).

``traces``  seeded harvest-trace generators (solar / rf / thermal);
``sim``     the fluid fleet simulator and its live-engine validation arm
            (the port's ``ResilientServeEngine`` on a device);
``search``  per-node (quant, target, period) co-design under accuracy SLOs.

Import is numpy only: the live-validation arm pulls in the serve stack,
lazily.
"""
from .search import (REFERENCE_ERROR_PCT, SLO_LEVELS, assign_slos,
                     candidate_space, codesign, frame_cost_table,
                     load_accuracy_table)
from .sim import (NodeConfig, epoch_schedule, fleet_report, live_validation,
                  measured_efficiency, outage_faultplan,
                  predict_engine_stats, rescale_outages, simulate_fleet,
                  simulate_node)
from .traces import (ARCHETYPES, DAY_S, DEFAULT_MIX, HarvestTrace, TraceSpec,
                     generate_fleet, make_trace)

__all__ = [
    "ARCHETYPES", "DAY_S", "DEFAULT_MIX", "HarvestTrace", "NodeConfig",
    "REFERENCE_ERROR_PCT", "SLO_LEVELS", "TraceSpec", "assign_slos",
    "candidate_space", "codesign", "epoch_schedule", "fleet_report",
    "frame_cost_table", "generate_fleet", "live_validation",
    "load_accuracy_table", "make_trace", "measured_efficiency",
    "outage_faultplan", "predict_engine_stats", "rescale_outages",
    "simulate_fleet", "simulate_node",
]
