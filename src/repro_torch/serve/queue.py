"""Admission-controlled request queue with slot recycling (DESIGN.md §10).

The port's own copy of ``repro.serve.queue`` (numpy and stdlib only).

``RequestQueue`` separates the two populations the lockstep engine
conflated: a bounded FIFO of *waiting* requests (arrival order
preserved; admission control rejects past ``max_waiting``) and a fixed
array of ``max_live`` *slots* — the decode lanes.  A request occupies
exactly one slot from admission to departure; a departing request's slot
is handed straight back to the admission pass, so a finishing lane is
re-filled the same step the finisher leaves (continuous batching's slot
recycling).  Requests can also depart mid-flight via ``cancel`` —
waiting requests leave the FIFO immediately, live ones are marked and
reaped by the scheduler at its next step boundary.

Pure host-side bookkeeping: no device, no pager — the scheduler composes
this with the pager's staged ops and the decode machinery.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

__all__ = ["RequestQueue", "ServeRequest"]


@dataclasses.dataclass
class ServeRequest:
    """One request's whole life: submitted → (waiting) → admitted/live →
    done or cancelled.  ``out`` accumulates tokens (prefill argmax first,
    then one per decode step) — the compat surface the legacy engine's
    ``Request`` exposed."""

    seq_id: int
    prompt: np.ndarray
    max_new: int
    submit_step: int = 0
    admit_step: int = -1       # -1 while waiting
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False

    @property
    def wait_steps(self) -> int:
        """Steps spent in the waiting FIFO before admission."""
        return max(self.admit_step - self.submit_step, 0)


class RequestQueue:
    def __init__(self, max_live: int, max_waiting: int = 0):
        assert max_live > 0, max_live
        self.max_live = max_live
        self.max_waiting = max_waiting  # 0 = unbounded
        self.waiting: collections.deque[ServeRequest] = collections.deque()
        self.slots: list[ServeRequest | None] = [None] * max_live
        self.rejected = 0

    # ---- arrival / departure ----

    def submit(self, req: ServeRequest) -> bool:
        """Enqueue; False (and ``rejected`` bumps) when admission control
        bounds the FIFO and it is full."""
        if self.max_waiting and len(self.waiting) >= self.max_waiting:
            self.rejected += 1
            req.cancelled = True
            return False
        self.waiting.append(req)
        return True

    def cancel(self, seq_id: int) -> str:
        """Departure mid-flight: "waiting" requests leave the FIFO now,
        "live" ones are marked for the scheduler's next reap; returns
        which population the request was in ("missing" otherwise)."""
        for req in self.waiting:
            if req.seq_id == seq_id:
                req.cancelled = True
                self.waiting.remove(req)
                return "waiting"
        for req in self.slots:
            if req is not None and req.seq_id == seq_id:
                req.cancelled = True
                return "live"
        return "missing"

    # ---- admission / recycling ----

    def admit(self, step: int) -> list[tuple[int, ServeRequest]]:
        """Fill every free slot FIFO-first; returns [(slot, request)].
        Ran twice per scheduler step: once at the top (slots freed while
        the queue was empty) and once after departures (same-step slot
        recycling)."""
        admitted = []
        for slot in range(self.max_live):
            if self.slots[slot] is not None or not self.waiting:
                continue
            req = self.waiting.popleft()
            req.admit_step = step
            self.slots[slot] = req
            admitted.append((slot, req))
        return admitted

    def release(self, slot: int) -> None:
        assert self.slots[slot] is not None, slot
        self.slots[slot] = None

    # ---- views ----

    def live(self) -> list[tuple[int, ServeRequest]]:
        """Occupied slots in slot order — the decode batch composition."""
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    @property
    def depth(self) -> int:
        return len(self.waiting)

    @property
    def n_live(self) -> int:
        return sum(r is not None for r in self.slots)
