"""Small statistics the metric readers share."""

from __future__ import annotations

import numpy as np


def weighted_quantile(values, weights, q: float) -> float | None:
    """The ``q`` quantile of ``values`` with each counted ``weights``
    times: the smallest value whose cumulative weight reaches ``q`` of the
    total (so a step's latency counts once for each op it answered)."""
    v = np.asarray(values, np.float64)
    w = np.asarray(weights, np.float64)
    keep = (w > 0) & ~np.isnan(v)
    v, w = v[keep], w[keep]
    if v.size == 0:
        return None
    order = np.argsort(v, kind="stable")
    cum = np.cumsum(w[order])
    return float(v[order][np.searchsorted(cum, q * cum[-1])])


def window(run, key: str, before_trace: bool = False):
    """A per-step column over the window's steps (in a traced run, with
    ``before_trace``, only those before the profiled stretch)."""
    end = run.traced_from if before_trace and run.trace else run.end
    return run.steps[key][run.first:end]
