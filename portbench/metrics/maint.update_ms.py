"""maint.update_ms: host time inside the maintenance scheduler's spans
(``maint.ops``, ``maint.sweep``) an update call, over the traced run's
steps before its profiled stretch."""

from portbench.bench.stats import window


def read(run, name):
    calls = int((window(run, "n_writes", True) > 0).sum())
    us = sum(e["dur"] for e in run.spans
             if e["name"] in ("maint.ops", "maint.sweep"))
    return us / 1e3 / calls if calls else None
