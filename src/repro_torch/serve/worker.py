"""Background index-maintenance worker (DESIGN.md §10).

The port's own copy of ``repro.serve.worker`` (stdlib only).

The lockstep engine drains maintenance *on* the decode path.  The worker
moves it off: with a non-eager maintenance policy the decode path's staged
updates only append/mark (I5′ keeps reads correct over the buffered
items), and the structural work — Rebalance / Expand / Merge to fixpoint —
runs here, triggered by the ``MaintenanceStats.pending`` high-water mark.

"Background" in this single-process reproduction means *off the
per-update decode path, at the step barrier*: the scheduler calls
``maybe_drain`` after each step's decode completes and before the next
step's reads are issued, so no read is in flight while the drain
restores I5 — the same quiescent-point argument the forest's ``flush``
makes.  An async-actor deployment would run the identical drain on a
worker thread under the same barrier.
"""

from __future__ import annotations

__all__ = ["MaintenanceWorker"]


class MaintenanceWorker:
    """Owns the drain policy over one pager's index.

    ``high_water``: drain when ``pager.pending`` (buffered items awaiting
    maintenance, the I5′ carry) reaches this mark; <= 0 disables the
    trigger (``force=True`` still drains — the final barrier / tests).
    """

    def __init__(self, pager, high_water: int | None = None):
        self.pager = pager
        self.high_water = (pager.cfg.maint_high_water
                           if high_water is None else high_water)
        self.drains = 0
        self.rounds = 0
        self.rebuilds = 0
        self.expands = 0
        self.merges = 0
        self.last_drain_step = -1

    def maybe_drain(self, step: int = 0, force: bool = False) -> bool:
        """Drain to fixpoint if pending crossed the high-water mark (or
        ``force``).  Returns whether a drain ran.  Must be called at a
        step barrier — no reads in flight."""
        if not force and (self.high_water <= 0
                          or self.pager.pending < self.high_water):
            return False
        ms = self.pager.flush()
        self.drains += 1
        self.last_drain_step = step
        if ms is not None:
            self.rounds += int(ms.rounds)
            self.rebuilds += int(ms.rebuilds)
            self.expands += int(ms.expands)
            self.merges += int(ms.merges)
        return True

    def stats(self) -> dict:
        return {"drains": self.drains, "rounds": self.rounds,
                "rebuilds": self.rebuilds, "expands": self.expands,
                "merges": self.merges,
                "last_drain_step": self.last_drain_step}
