"""Maintenance scheduler (port of ``repro.maintenance``): the eager,
deferred and budgeted policies."""

from repro_torch.maintenance.policy import KINDS, MaintenancePolicy, parse_policy
from repro_torch.maintenance.stats import MaintenanceStats

__all__ = ["KINDS", "MaintenancePolicy", "MaintenanceStats", "parse_policy"]
