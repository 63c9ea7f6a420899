"""engine.dispatch_ms: host time inside the read engine's spans
(``engine.<engine>.lookup`` / ``.successor`` / ``.scan``, REPRO_TRACE)
a read call, over the traced run's steps before its profiled stretch."""


def read(run, name):
    calls = run.traced_from - run.first
    us = sum(e["dur"] for e in run.spans if e["name"].startswith("engine."))
    return us / 1e3 / calls if calls else None
