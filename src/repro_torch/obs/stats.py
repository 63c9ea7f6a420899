"""Counter tuples riding the read path and the serve loop (port of
``repro.obs.stats``).

Read-path stats (``SearchStats``, ``RouterStats``, ``TransferStats`` and
their carrier ``ReadStats``) follow the JAX contract: a ``NamedTuple`` of
small int32 tensors on the read's device, a ``zero()`` constructor, ``of``
from a batch's per-query columns, ``reduce`` over a stacked (S,) leading
axis (rounds-like fields take the max, work-like fields sum), ``merge`` to
fold two instances without a host sync, and ``asdict`` — the one method
that syncs — for JSON rows and logging.  Collection is gated by
``TreeConfig.collect_stats`` and happens in the dispatch layers
(`core.engine`, `distributed.forest`), never inside an engine hook, so the
stats of both engines derive from the same bit-identical columns.

The serve loop is host-driven, so ``ServeStats`` / ``ScanStats`` are
``NamedTuple``s of numpy scalars with the JAX fields and methods
(``LATENCY_RESERVOIR`` ring buffer included).  ``MaintenanceStats`` is
re-exported from `repro_torch.maintenance.stats`, where it is defined.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.maintenance.stats import MaintenanceStats

HOP_BINS = 16          # SearchStats histogram bins (hops clip to the last)
OCC_ROUNDS = 16        # SearchStats per-round occupancy window
LATENCY_RESERVOIR = 512  # ServeStats ring-buffer capacity (decode steps)
TRANSFER_BLOCK_SIZES = (8, 16, 32, 64)  # TransferStats block-size sweep (B)

_I32 = np.int32
_T32 = torch.int32

__all__ = [
    "HOP_BINS", "OCC_ROUNDS", "LATENCY_RESERVOIR", "TRANSFER_BLOCK_SIZES",
    "MaintenanceStats", "SearchStats", "RouterStats", "TransferStats",
    "ReadStats", "ScanStats", "ServeStats",
]


def _host(x) -> np.ndarray:
    """A per-lane column (numpy, list or tensor) as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _scalar(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_T32, device=device)


def _sum(x, dim=None) -> torch.Tensor:
    """int32 sum (torch widens integer sums to int64 by default)."""
    if dim is None:
        return torch.sum(x, dtype=_T32)
    return torch.sum(x, dim=dim, dtype=_T32)


class SearchStats(NamedTuple):
    """One read batch, as the paper would measure it (§5, Table 1).

    ``hops`` is the per-query transfer statistic both engines report bit
    for bit (ΔNodes visited), so every field derives from the same columns
    on either engine: ``rounds`` is the frontier's round count (the batch's
    max hops), and ``occupancy[r]`` counts the lanes still active entering
    round r (a query with h hops is active in rounds 0..h-1).
    """

    queries: torch.Tensor      # () int32 lanes in the batch (pads included)
    pad_lanes: torch.Tensor    # () int32 born-resolved ROUTE_LEFT lanes
    hops_sum: torch.Tensor     # () int32 total ΔNode transfers
    hops_max: torch.Tensor     # () int32 deepest walk in the batch
    rounds: torch.Tensor       # () int32 lockstep frontier rounds (= hops_max)
    buffer_hits: torch.Tensor  # () int32 queries resolved from overflow buffers
    hops_hist: torch.Tensor    # (HOP_BINS,) int32 hops histogram (clipped)
    occupancy: torch.Tensor    # (OCC_ROUNDS,) int32 active lanes per round

    @classmethod
    def zero(cls, device=None) -> "SearchStats":
        z = _scalar(0, device)
        return cls(queries=z, pad_lanes=z, hops_sum=z, hops_max=z, rounds=z,
                   buffer_hits=z,
                   hops_hist=torch.zeros(HOP_BINS, dtype=_T32, device=device),
                   occupancy=torch.zeros(OCC_ROUNDS, dtype=_T32,
                                         device=device))

    @classmethod
    def of(cls, hops, pad, buffer_hit) -> "SearchStats":
        """Derive the batch's stats from its per-query columns: ``hops[K]``
        int32, ``pad[K]`` bool (sentinel lanes) and ``buffer_hit[K]`` bool
        (found through an overflow buffer)."""
        hops = hops.to(_T32)
        dev = hops.device
        hmax = hops.max()
        hist = torch.zeros(HOP_BINS, dtype=_T32, device=dev).index_add_(
            0, hops.clamp(0, HOP_BINS - 1).long(), torch.ones_like(hops))
        occ = _sum(hops[None, :] > torch.arange(OCC_ROUNDS, dtype=_T32,
                                                device=dev)[:, None], 1)
        return cls(queries=_scalar(hops.shape[0], dev), pad_lanes=_sum(pad),
                   hops_sum=_sum(hops), hops_max=hmax, rounds=hmax,
                   buffer_hits=_sum(buffer_hit), hops_hist=hist,
                   occupancy=occ)

    @classmethod
    def reduce(cls, stacked: "SearchStats") -> "SearchStats":
        """Aggregate stacked (S,) legs: rounds-like fields max (concurrent
        frontiers: the critical path), work-like fields sum."""
        return cls(queries=_sum(stacked.queries),
                   pad_lanes=_sum(stacked.pad_lanes),
                   hops_sum=_sum(stacked.hops_sum),
                   hops_max=stacked.hops_max.max(),
                   rounds=stacked.rounds.max(),
                   buffer_hits=_sum(stacked.buffer_hits),
                   hops_hist=_sum(stacked.hops_hist, 0),
                   occupancy=_sum(stacked.occupancy, 0))

    def merge(self, other: "SearchStats") -> "SearchStats":
        """Fold another batch's stats in (stays on the device)."""
        return SearchStats(
            queries=self.queries + other.queries,
            pad_lanes=self.pad_lanes + other.pad_lanes,
            hops_sum=self.hops_sum + other.hops_sum,
            hops_max=torch.maximum(self.hops_max, other.hops_max),
            rounds=torch.maximum(self.rounds, other.rounds),
            buffer_hits=self.buffer_hits + other.buffer_hits,
            hops_hist=self.hops_hist + other.hops_hist,
            occupancy=self.occupancy + other.occupancy)

    def asdict(self) -> dict:
        real = max(int(self.queries) - int(self.pad_lanes), 1)
        return {
            "queries": int(self.queries),
            "pad_lanes": int(self.pad_lanes),
            "hops_sum": int(self.hops_sum),
            "hops_max": int(self.hops_max),
            "hops_mean": round(int(self.hops_sum) / real, 3),
            "rounds": int(self.rounds),
            "buffer_hits": int(self.buffer_hits),
            "hops_hist": _host(self.hops_hist).tolist(),
            "occupancy": _host(self.occupancy).tolist(),
        }


class RouterStats(NamedTuple):
    """One routed batch through the forest router (skew telemetry)."""

    lanes: torch.Tensor    # (S,) int32 ops routed to each shard
    clamped: torch.Tensor  # () int32 out-of-domain keys clamped by the router
    batches: torch.Tensor  # () int32 batches folded in (1 for a fresh batch)

    @classmethod
    def zero(cls, num_shards: int, device=None) -> "RouterStats":
        return cls(lanes=torch.zeros(num_shards, dtype=_T32, device=device),
                   clamped=_scalar(0, device), batches=_scalar(0, device))

    @classmethod
    def of(cls, lanes, clamped) -> "RouterStats":
        lanes = torch.as_tensor(lanes, dtype=_T32)
        return cls(lanes=lanes, clamped=_scalar(clamped, lanes.device),
                   batches=_scalar(1, lanes.device))

    @classmethod
    def reduce(cls, stacked: "RouterStats") -> "RouterStats":
        """Aggregate stacked (N, S) legs: everything sums."""
        return cls(lanes=_sum(stacked.lanes, 0),
                   clamped=_sum(stacked.clamped),
                   batches=_sum(stacked.batches))

    def merge(self, other: "RouterStats") -> "RouterStats":
        return RouterStats(lanes=self.lanes + other.lanes,
                           clamped=self.clamped + other.clamped,
                           batches=self.batches + other.batches)

    def skew(self) -> float:
        """max/mean shard load — 1.0 is a perfectly balanced router."""
        lanes = _host(self.lanes).astype(np.float64)
        mean = lanes.mean()
        return float(lanes.max() / mean) if mean > 0 else 1.0

    def asdict(self) -> dict:
        return {
            "lanes": _host(self.lanes).tolist(),
            "clamped": int(self.clamped),
            "batches": int(self.batches),
            "skew": round(self.skew(), 3),
        }


class TransferStats(NamedTuple):
    """Measured memory transfers of one read batch in the ideal-cache model
    (the paper's O(log_B N) claim, Table 1 / Lemma 2.1).

    Derived in the dispatch layers by replaying the walk's per-level
    indices on the device (`repro_torch.obs.transfers`) from (arena, roots,
    keys) alone, so it is engine- and dispatch-independent by construction.
    ``blocks[i]`` is the batch total of distinct
    ``TRANSFER_BLOCK_SIZES[i]``-element blocks touched per query (what
    `core.baselines.count_block_transfers` counts, exactly);
    ``buffer_probes`` (one SEARCHNODE buffer-row read per real query) is
    kept out of the block counts, as the analytical model keeps it out.
    """

    queries: torch.Tensor         # () int32 lanes (pads included)
    pad_lanes: torch.Tensor       # () int32 born-resolved ROUTE_LEFT lanes
    dnode_visits: torch.Tensor    # () int32 ΔNodes entered (batch sum)
    router_touches: torch.Tensor  # () int32 element reads steering the walk
    leaf_touches: torch.Tensor    # () int32 terminal leaf-test reads
    buffer_probes: torch.Tensor   # () int32 SEARCHNODE buffer-row probes
    blocks: torch.Tensor          # (len(TRANSFER_BLOCK_SIZES),) int32 totals
    batches: torch.Tensor         # () int32 batches folded in

    @classmethod
    def zero(cls, device=None) -> "TransferStats":
        z = _scalar(0, device)
        return cls(queries=z, pad_lanes=z, dnode_visits=z, router_touches=z,
                   leaf_touches=z, buffer_probes=z,
                   blocks=torch.zeros(len(TRANSFER_BLOCK_SIZES), dtype=_T32,
                                      device=device),
                   batches=z)

    @classmethod
    def of(cls, pad, visits, router, leaf, blocks) -> "TransferStats":
        """From per-query columns: ``pad[K]`` bool, ``visits[K]`` /
        ``router[K]`` / ``leaf[K]`` int32 counts and ``blocks[K,
        len(TRANSFER_BLOCK_SIZES)]`` distinct-block counts (all zero on pad
        lanes)."""
        dev = pad.device
        return cls(queries=_scalar(pad.shape[0], dev), pad_lanes=_sum(pad),
                   dnode_visits=_sum(visits), router_touches=_sum(router),
                   leaf_touches=_sum(leaf), buffer_probes=_sum(~pad),
                   blocks=_sum(blocks, 0), batches=_scalar(1, dev))

    @classmethod
    def reduce(cls, stacked: "TransferStats") -> "TransferStats":
        """Aggregate stacked (S,) legs: transfers are work — all sum."""
        return cls(*(_sum(x, 0) for x in stacked))

    def merge(self, other: "TransferStats") -> "TransferStats":
        return TransferStats(*(a + b for a, b in zip(self, other)))

    def asdict(self) -> dict:
        real = max(int(self.queries) - int(self.pad_lanes), 1)
        out = {
            "queries": int(self.queries),
            "pad_lanes": int(self.pad_lanes),
            "dnode_visits": int(self.dnode_visits),
            "router_touches": int(self.router_touches),
            "leaf_touches": int(self.leaf_touches),
            "buffer_probes": int(self.buffer_probes),
            "batches": int(self.batches),
            "visits_mean": round(int(self.dnode_visits) / real, 3),
        }
        blocks = _host(self.blocks).tolist()
        for i, b in enumerate(TRANSFER_BLOCK_SIZES):
            out[f"blocks_b{b}"] = int(blocks[i])
            out[f"blocks_b{b}_mean"] = round(int(blocks[i]) / real, 3)
        return out


class ReadStats(NamedTuple):
    """The trailing element of a stats-collecting read: the batch's
    ``SearchStats``, on the forest dispatch the router's ``RouterStats``,
    and under the ``collect_transfers`` sub-gate the measured
    ``TransferStats`` (None where absent)."""

    search: SearchStats
    router: RouterStats | None = None
    transfers: TransferStats | None = None


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
