"""Trace spans, event counters and trace dumps, off by default (port of
``repro.obs.trace``).

Gated by the ``REPRO_TRACE`` environment variable, read at call time.
Unset (or ``0``) makes every span helper a no-op.  With ``REPRO_TRACE=1``:

- ``span(name)`` and ``annotate(name)`` open a
  ``torch.profiler.record_function`` range, which a ``torch.profiler``
  trace shows on the host timeline beside the kernels it launched.  The
  JAX package separates host spans from device-side scopes; eager PyTorch
  has one kind, so both names map to it.  Each completed span also records
  a host wall-clock event for `write_chrome_trace`.
- ``bump(name)`` counts an event (``delta_walk.dispatch`` counts walk
  dispatches); ``counters()`` / ``reset_counters()`` read and clear them.

Unconditional (asking for the file is the opt-in):

- ``capture(logdir)`` runs a region under ``torch.profiler.profile`` over
  the CPU and, where there is one, the CUDA card, and writes its Chrome
  trace into ``logdir``; ``trace_run`` is the one-call form that
  synchronizes the card before the capture closes.
- ``write_chrome_trace(path)`` dumps the recorded span events as a
  Chrome-trace / perfetto JSON timeline (host wall clock only).

Counters and the event ring share one module lock: the serve layer's
maintenance worker may run on its own thread.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time

ENV = "REPRO_TRACE"

_COUNTS: dict[str, int] = {}
# completed span events for `write_chrome_trace`, bounded so a long loop
# cannot grow without limit (drops count under the reserved name below)
_EVENTS: list[dict] = []
_EVENT_CAP = 200_000
_DROPPED = "trace.events_dropped"
_LOCK = threading.Lock()
_EPOCH = time.perf_counter()


def enabled() -> bool:
    """True when ``REPRO_TRACE`` asks for spans (read at call time)."""
    env = os.environ.get(ENV, "").strip()
    return bool(env) and env.lower() not in ("0", "false", "no")


def bump(name: str, n: int = 1) -> None:
    """Count an event under ``name`` (no-op unless ``REPRO_TRACE``)."""
    if enabled():
        with _LOCK:
            _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict[str, int]:
    """Snapshot of the event counters accumulated so far."""
    with _LOCK:
        return dict(_COUNTS)


def reset_counters() -> None:
    """Clear the counters (the event ring stays: `reset_events`)."""
    with _LOCK:
        _COUNTS.clear()


def reset_events() -> None:
    with _LOCK:
        _EVENTS.clear()


def _record_event(name: str, t0: float, t1: float) -> None:
    ev = {"name": name, "ph": "X", "pid": os.getpid(),
          "tid": threading.get_ident(),
          "ts": round((t0 - _EPOCH) * 1e6, 3),
          "dur": round((t1 - t0) * 1e6, 3)}
    with _LOCK:
        if len(_EVENTS) < _EVENT_CAP:
            _EVENTS.append(ev)
        else:
            _COUNTS[_DROPPED] = _COUNTS.get(_DROPPED, 0) + 1


def events() -> list[dict]:
    """Snapshot of the recorded Chrome-trace span events."""
    with _LOCK:
        return [dict(e) for e in _EVENTS]


def write_chrome_trace(path: str) -> int:
    """Write the recorded span events as Chrome-trace JSON (open in
    ``chrome://tracing`` or perfetto).  Returns the event count written;
    only spans entered under ``REPRO_TRACE=1`` recorded anything."""
    evs = events()
    with open(path, "w") as f:
        json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, f)
    return len(evs)


@contextlib.contextmanager
def _timed_span(name: str):
    import torch

    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _record_event(name, t0, time.perf_counter())


def span(name: str):
    """A profiler range and a wall-clock event around a host-driven
    section (no-op when off)."""
    if not enabled():
        return contextlib.nullcontext()
    bump(name)
    return _timed_span(name)


annotate = span


def traced(name: str):
    """Decorator form of ``span``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def capture(logdir: str):
    """Profile the enclosed region (CPU, and CUDA where a card is present)
    and write its Chrome trace to ``logdir/trace_<pid>_<n>.json``.  Yields
    the ``torch.profiler.profile`` object, whose ``events()`` and
    ``key_averages()`` the caller may read after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts, acc_events=True) as prof:
        yield prof
    n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}_{n}.json"))


def trace_run(fn, *args, logdir: str, **kwargs):
    """Run ``fn(*args, **kwargs)`` under ``capture`` and wait for the card
    before the capture closes, so the trace covers the device work."""
    import torch

    with capture(logdir):
        out = fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return out
