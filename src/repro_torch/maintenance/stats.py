"""``MaintenanceStats`` — what one update step's maintenance did.

Port of ``repro.obs.stats.MaintenanceStats`` (re-exported by
``repro.maintenance.stats``).  The eager scheduler counts on the host, so
the fields are Python ints.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence


class MaintenanceStats(NamedTuple):
    """Returned (beside the tree and the per-op results) by every
    ``update_batch`` / ``Index.update`` call, and by ``flush``."""

    rounds: int = 0      # scheduler rounds taken
    rebuilds: int = 0    # Rebalance mirror-swaps
    expands: int = 0     # child ΔNodes allocated by Expand
    merges: int = 0      # successful Merge splices
    pending: int = 0     # buffered items carried forward (I5')
    reclaimed: int = 0   # arena slots freed by Merge splicing away a child

    @classmethod
    def reduce(cls, per_shard: Sequence["MaintenanceStats"]
               ) -> "MaintenanceStats":
        """Aggregate per-shard stats: ``rounds`` is the critical path (the
        max over shards, which the JAX forest runs concurrently), the work
        counters and ``pending`` sum."""
        return cls(rounds=max(s.rounds for s in per_shard),
                   rebuilds=sum(s.rebuilds for s in per_shard),
                   expands=sum(s.expands for s in per_shard),
                   merges=sum(s.merges for s in per_shard),
                   pending=sum(s.pending for s in per_shard),
                   reclaimed=sum(s.reclaimed for s in per_shard))
