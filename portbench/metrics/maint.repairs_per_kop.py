"""maint.repairs_per_kop: Rebalances, Expands and Merges (the update
calls' MaintenanceStats, exact counts) per 1,000 update ops applied in
the window."""

from portbench.bench.stats import window


def read(run, name):
    ops = window(run, "n_writes").sum()
    return window(run, "repairs").sum() / ops * 1e3 if ops else None
