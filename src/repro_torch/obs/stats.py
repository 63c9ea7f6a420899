"""Serve-side telemetry (port of ``ServeStats`` and ``ScanStats`` from
``repro.obs.stats``).

The JAX classes are pytrees of small jax arrays so they can ride jitted
state; the port's serve loop is host-driven, so these are ``NamedTuple``s of
numpy scalars with the same fields, the same ``LATENCY_RESERVOIR`` ring
buffer and the same methods (``zero``, ``record``, ``record_probe``,
``of``, ``merge``, ``percentiles``, ``asdict``).  Counters are int32 and
latencies float32 microseconds, as there.  The other stats classes of that
module (search, router, transfer, read) wait for the rest of obs/
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

LATENCY_RESERVOIR = 512  # ServeStats ring-buffer capacity (decode steps)

_I32 = np.int32


def _host(x) -> np.ndarray:
    """A per-lane column (numpy, list or tensor) as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ScanStats(NamedTuple):
    """Range-scan / bulk-ordered-read telemetry: one ``of`` per scan
    dispatch (a whole lane batch), folded with ``merge``.  ``truncated``
    counts lanes whose output row filled before the range was exhausted
    (``more``)."""

    scans: np.int32      # scan dispatches folded in
    lanes: np.int32      # scan lanes served
    emitted: np.int32    # (key, payload) rows emitted
    truncated: np.int32  # lanes that filled max_items (more)
    hops_sum: np.int32   # total ΔNode visits across lanes
    hops_max: np.int32   # worst single-lane ΔNode visits

    @classmethod
    def zero(cls) -> "ScanStats":
        z = _I32(0)
        return cls(scans=z, lanes=z, emitted=z, truncated=z, hops_sum=z,
                   hops_max=z)

    @classmethod
    def of(cls, n, hops, more) -> "ScanStats":
        """Build from one scan dispatch's per-lane columns."""
        n, hops, more = _host(n), _host(hops), _host(more)
        return cls(scans=_I32(1), lanes=_I32(n.shape[0]),
                   emitted=_I32(n.sum()),
                   truncated=_I32(more.astype(np.int32).sum()),
                   hops_sum=_I32(hops.sum()),
                   hops_max=_I32(hops.max() if hops.size else 0))

    def merge(self, other: "ScanStats") -> "ScanStats":
        return ScanStats(scans=_I32(self.scans + other.scans),
                         lanes=_I32(self.lanes + other.lanes),
                         emitted=_I32(self.emitted + other.emitted),
                         truncated=_I32(self.truncated + other.truncated),
                         hops_sum=_I32(self.hops_sum + other.hops_sum),
                         hops_max=_I32(max(self.hops_max, other.hops_max)))

    def asdict(self) -> dict:
        return {k: int(v) for k, v in self._asdict().items()}


class ServeStats(NamedTuple):
    """Decode-loop telemetry: a fixed-size latency reservoir (ring buffer
    over the last ``LATENCY_RESERVOIR`` decode steps; p50/p99 come from
    it) plus flush, pending, queue, admission, combining, fused-view and
    probe counters (the scheduler's fields default to zero on every
    ``record``, so the lockstep loop records through the same class)."""

    steps: np.int32         # decode steps recorded
    flushes: np.int32       # background flushes triggered
    pending_hwm: np.int32   # max pending maintenance seen
    queue_hwm: np.int32     # max waiting-queue depth seen
    admitted: np.int32      # requests admitted into live slots
    admit_wait: np.int32    # total steps admitted requests waited
    combined: np.int32      # ops eliminated by op-combining
    view_hits: np.int32     # fused-view cache hits observed
    view_builds: np.int32   # fused-view cache builds observed
    probe_queries: np.int32  # read-service probe lookups issued
    probe_hits: np.int32     # probes that resolved a mapping
    lat_us: np.ndarray      # (LATENCY_RESERVOIR,) float32 step latencies

    @classmethod
    def zero(cls) -> "ServeStats":
        z = _I32(0)
        return cls(steps=z, flushes=z, pending_hwm=z, queue_hwm=z,
                   admitted=z, admit_wait=z, combined=z, view_hits=z,
                   view_builds=z, probe_queries=z, probe_hits=z,
                   lat_us=np.zeros((LATENCY_RESERVOIR,), np.float32))

    def record(self, seconds, *, pending: int = 0, flushed: bool = False,
               queue_depth: int = 0, admitted: int = 0, admit_wait: int = 0,
               combined: int = 0, view_hits: int = 0,
               view_builds: int = 0) -> "ServeStats":
        """Fold one decode step in (ring-buffer write at ``steps`` mod
        capacity)."""
        lat = self.lat_us.copy()
        lat[int(self.steps) % lat.shape[0]] = np.float32(seconds) * 1e6
        return ServeStats(
            steps=_I32(self.steps + 1),
            flushes=_I32(self.flushes + int(flushed)),
            pending_hwm=_I32(max(self.pending_hwm, pending)),
            queue_hwm=_I32(max(self.queue_hwm, queue_depth)),
            admitted=_I32(self.admitted + admitted),
            admit_wait=_I32(self.admit_wait + admit_wait),
            combined=_I32(self.combined + combined),
            view_hits=_I32(self.view_hits + view_hits),
            view_builds=_I32(self.view_builds + view_builds),
            probe_queries=self.probe_queries,
            probe_hits=self.probe_hits,
            lat_us=lat,
        )

    def record_probe(self, queries: int, hits: int) -> "ServeStats":
        """Fold one read-service ``probe`` call in (between decode steps —
        bumps no step counter and writes no latency sample)."""
        return self._replace(
            probe_queries=_I32(self.probe_queries + queries),
            probe_hits=_I32(self.probe_hits + hits))

    def valid_latencies(self) -> np.ndarray:
        """The recorded step latencies (µs)."""
        n = min(int(self.steps), int(self.lat_us.shape[0]))
        return self.lat_us[:n] if n else np.zeros((0,), np.float32)

    def percentiles(self, qs=(50, 99)) -> dict:
        lat = self.valid_latencies()
        if lat.size == 0:
            return {f"p{q}_us": 0.0 for q in qs}
        return {f"p{q}_us": round(float(np.percentile(lat, q)), 1)
                for q in qs}

    def asdict(self) -> dict:
        out = {k: int(v) for k, v in self._asdict().items() if k != "lat_us"}
        out.update(self.percentiles())
        return out
