"""Host-facing range-scan result types (the port's own copy of
``repro.core.scan``, which the port may not import).

The engine layer speaks packed rows: ``engine.scan`` returns
``(out, n, hops, more)`` with ``out`` holding qpacked (key | payload)
values padded with the walk sentinel.  The API layer unpacks that into a
``ScanResult`` per lane — plain numpy views plus an optional
``ScanCursor`` continuation when the caller's ``max_items`` buffer
filled before the range was exhausted.

A ``ScanCursor`` is deliberately tiny: it records the last key the
previous call emitted plus the original inclusive upper bound.  Because
the kernel's start bound is exclusive in key space, resuming is just
"scan again from ``last_key``" — no tree state, no snapshot, and
concurrent maintenance between pages is harmless (the page boundary is a
key, not a pointer).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ScanCursor(NamedTuple):
    """Continuation token for a truncated ``range_scan`` page.

    ``last_key`` is the largest key the previous page emitted (the next
    page starts strictly after it); ``hi`` is the original inclusive
    upper bound, carried so ``Index.range_scan(..., cursor=c)`` callers
    don't have to re-thread it.
    """

    last_key: int
    hi: int


class ScanResult(NamedTuple):
    """One lane's unpacked range-scan page.

    ``keys``/``payloads`` are length-``count`` numpy views in ascending
    key order.  ``more`` is True when the page filled ``max_items``
    before exhausting ``[lo, hi]``; ``cursor`` is then the continuation
    token (``None`` on the final page).
    """

    keys: np.ndarray
    payloads: np.ndarray
    more: bool
    cursor: ScanCursor | None

    @property
    def count(self) -> int:
        return int(self.keys.shape[0])

    def items(self) -> list[tuple[int, int]]:
        """Host-side (key, payload) pairs, key-sorted — the same shape
        ``Index.live_items`` returns, for oracle-style comparisons."""
        return [(int(k), int(p)) for k, p in zip(self.keys, self.payloads)]
