"""maint.repair_ms: host time inside the repairs' spans (``maint.rebalance``,
``maint.expand``, ``maint.merge``, REPRO_TRACE) an update call, over the
traced run's steps before its profiled stretch: the window and the
denominator of ``maint.update_ms``, whose spans hold these.  None where
the event ring dropped events (a partial ring would count too little) or
the program has no ``maint.batch`` span."""

from portbench.bench.stats import window

REPAIRS = ("maint.rebalance", "maint.expand", "maint.merge")


def read(run, name):
    from repro_torch.obs import trace

    if "trace.events_dropped" in trace.counters():
        return None
    if not any(e["name"] == "maint.batch" for e in run.spans):
        return None
    calls = int((window(run, "n_writes", True) > 0).sum())
    us = sum(e["dur"] for e in run.spans if e["name"] in REPAIRS)
    return us / 1e3 / calls if calls else None
