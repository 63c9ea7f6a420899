"""Trace spans and event counters, off by default (port of the part of
``repro.obs.trace`` the engine and the scheduler call).

Gated by the ``REPRO_TRACE`` environment variable, read at call time.
Unset (or ``0``) makes every helper a no-op.  With ``REPRO_TRACE=1``:

- ``span(name)`` and ``annotate(name)`` open a
  ``torch.profiler.record_function`` range, which a ``torch.profiler``
  trace shows on the host timeline beside the kernels it launched.  The
  JAX package separates host spans from device-side scopes; eager PyTorch
  has one kind, so both names map to it.
- ``bump(name)`` counts an event (``delta_walk.dispatch`` counts walk
  dispatches); ``counters()`` / ``reset_counters()`` read and clear them.
"""

from __future__ import annotations

import contextlib
import os
import threading

ENV = "REPRO_TRACE"

_COUNTS: dict[str, int] = {}
_LOCK = threading.Lock()


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
    with _LOCK:
        _COUNTS.clear()


def span(name: str):
    """A profiler range around a host-driven section (no-op when off)."""
    if not enabled():
        return contextlib.nullcontext()
    import torch

    bump(name)
    return torch.profiler.record_function(name)


annotate = span
