"""Reduction of a ``torch.profiler`` trace to device time, on the events'
intervals: the device's busy time as the union of every CUDA interval in
a window (an overlap is counted once), the idle gaps between them, and
for each gap what the host was doing in it.
"""

from __future__ import annotations

from collections import defaultdict

def split_events(prof):
    """(device events, host events) of a finished profile, each a list of
    (start_us, end_us, name) sorted by start.  A host span's mirror on the
    device timeline (a user annotation: it covers the span's kernels and
    the gaps between them) is no device work and is left out."""
    import torch

    dev, host = [], []
    for evt in prof.events():
        row = (float(evt.time_range.start), float(evt.time_range.end),
               evt.name)
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            host.append(row)
        elif not getattr(evt, "is_user_annotation", False):
            dev.append(row)
    names = {h[2] for h in host}
    dev = sorted(d for d in dev if d[2] not in names)
    host.sort()
    return dev, host


def busy_intervals(dev, lo: float, hi: float) -> list:
    """The union of the device intervals, clipped to [lo, hi]."""
    out = []
    for s, e, _ in dev:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps(busy: list, lo: float, hi: float) -> list:
    """(start, end) of each stretch in [lo, hi] with no device interval."""
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def _is_op(name: str) -> bool:
    """An operator or runtime call, as against a named span."""
    return "::" in name or name.startswith(("cuda", "cu"))


def host_at(host, points) -> list:
    """For each time in ``points`` (ascending), ``"<span> > <op>"``: the
    innermost named span and the innermost event of any kind that cover
    it on the host (the span alone where it is the innermost; "idle"
    where nothing covers the time)."""
    starts = [h[0] for h in host]
    out, active, j = [], [], 0
    for t in points:
        while j < len(host) and starts[j] <= t:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= t]
        if not active:
            out.append("idle")
            continue
        spans = [h for h in active if not _is_op(h[2])]
        span = max(spans)[2] if spans else "-"
        op = max(active)[2]
        out.append(span if op == span else f"{span} > {op}")
    return out


def top(pairs: dict, n: int = 10) -> list:
    """The ``n`` largest (name, seconds) entries, largest first."""
    return [[k, v] for k, v in sorted(pairs.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(dev, host, lo: float, hi: float, n: int = 10) -> dict:
    """The device operations that took most time in [lo, hi], and the idle
    time there summed by what the host was doing, in seconds."""
    ops = defaultdict(float)
    for s, e, name in dev:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            ops[name[:160]] += (e - s) / 1e6
    gaps = idle_gaps(busy_intervals(dev, lo, hi), lo, hi)
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    labels = host_at(host, [m for m, _ in mids])
    idle = defaultdict(float)
    for (_, d), label in zip(mids, labels):
        idle[label[:160]] += d / 1e6
    return {"device_ops": top(ops, n), "idle_gaps": top(idle, n)}
