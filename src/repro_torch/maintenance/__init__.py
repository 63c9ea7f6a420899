"""Maintenance scheduler (port of ``repro.maintenance``): the eager,
deferred and budgeted policies."""

from repro_torch.maintenance.policy import KINDS, MaintenancePolicy, parse_policy
from repro_torch.maintenance.stats import MaintenanceStats
from repro_torch.maintenance.scheduler import flush, pending_count, run_update

__all__ = [
    "KINDS",
    "MaintenancePolicy",
    "MaintenanceStats",
    "parse_policy",
    "flush",
    "pending_count",
    "run_update",
]
