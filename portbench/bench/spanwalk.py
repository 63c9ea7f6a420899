"""Interval containment over a profiler trace's host events: which CUDA
runtime calls fall inside which named ranges.

The host events are `devtrace.split_events`' rows, (start_us, end_us,
name) sorted by start.  A range is a ``record_function`` span
(``maint.batch``, ``client.read``, ``engine.lockstep.lookup``); a call is
a CUDA runtime call that the profiler records on the host
(``cudaLaunchKernel``, ``cudaStreamSynchronize``).  Spans of one thread
nest or lie apart, so containment in the union of ranges is containment
in one of them.
"""

from __future__ import annotations

import math
from bisect import bisect_right

from portbench.bench import devtrace


def ranges(host, match, lo: float, hi: float) -> list:
    """The host events whose name ``match`` accepts that lie whole in
    [lo, hi]."""
    return [ev for ev in host if match(ev[2]) and lo <= ev[0] and ev[1] <= hi]


def inside(host, match, outer) -> list:
    """The host events whose name ``match`` accepts that lie whole inside
    one of the events ``outer``."""
    union = devtrace.busy_intervals(sorted(outer), -math.inf, math.inf)
    starts = [s for s, _ in union]
    out = []
    for ev in host:
        if not match(ev[2]):
            continue
        i = bisect_right(starts, ev[0]) - 1
        if i >= 0 and ev[1] <= union[i][1]:
            out.append(ev)
    return out
