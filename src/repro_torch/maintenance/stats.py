"""``MaintenanceStats`` — what one update step's maintenance did.

Port of ``repro.obs.stats.MaintenanceStats`` (re-exported by
``repro.maintenance.stats``).  The eager scheduler counts on the host, so
the fields are Python ints.
"""

from __future__ import annotations

from typing import NamedTuple


class MaintenanceStats(NamedTuple):
    """Returned (beside the tree and the per-op results) by every
    ``update_batch`` / ``Index.update`` call, and by ``flush``."""

    rounds: int = 0      # scheduler rounds taken
    rebuilds: int = 0    # Rebalance mirror-swaps
    expands: int = 0     # child ΔNodes allocated by Expand
    merges: int = 0      # successful Merge splices
    pending: int = 0     # buffered items carried forward (I5')
    reclaimed: int = 0   # arena slots freed by Merge splicing away a child
