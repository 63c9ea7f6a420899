"""Maintenance policies — the static half of the scheduler.

Port of ``repro.maintenance.policy``.  A policy is hashable and lives
inside ``TreeConfig`` as its string form.  The string forms accepted by
``parse_policy`` (and by ``make_index(maintenance=...)``):

    "eager"        drain to fixpoint inside every update step (default)
    "deferred"     updates only append/mark; maintenance on flush()
    "budgeted:K"   at most K ΔNode repairs per update batch (K >= 1)
"""

from __future__ import annotations

import dataclasses

KINDS = ("eager", "deferred", "budgeted")


@dataclasses.dataclass(frozen=True)
class MaintenancePolicy:
    """Parsed maintenance policy (hashable).

    kind:   one of ``KINDS``.
    budget: voluntary ΔNode repairs per update batch (budgeted only;
            0 for eager — unlimited by construction — and deferred).
    """

    kind: str = "eager"
    budget: int = 0

    @property
    def eager(self) -> bool:
        return self.kind == "eager"

    def __str__(self) -> str:
        if self.kind == "budgeted":
            return f"budgeted:{self.budget}"
        return self.kind


def parse_policy(spec: "str | MaintenancePolicy") -> MaintenancePolicy:
    """Parse ``"eager" | "deferred" | "budgeted:K"`` (idempotent on an
    already-parsed policy).  Raises ``ValueError`` on anything else."""
    if isinstance(spec, MaintenancePolicy):
        return spec
    if not isinstance(spec, str):
        raise ValueError(f"maintenance policy must be a string, got {spec!r}")
    name, sep, arg = spec.partition(":")
    name = name.strip()
    if name == "budgeted":
        try:
            budget = int(arg)
        except ValueError:
            raise ValueError(
                f"budgeted policy needs an integer budget, got {spec!r}"
            ) from None
        if budget < 1:
            raise ValueError(f"budgeted policy needs budget >= 1, got {spec!r}")
        return MaintenancePolicy(kind="budgeted", budget=budget)
    if sep or name not in ("eager", "deferred"):
        raise ValueError(
            f"unknown maintenance policy {spec!r}; expected one of "
            f"'eager', 'deferred', 'budgeted:K'")
    return MaintenancePolicy(kind=name)
