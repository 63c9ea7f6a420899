"""Pure-Python oracle for ΔTree semantics (the port's own copy of
``repro.core.oracle``, so checks of the port need nothing of the JAX
package).

The ΔTree dictionary semantics (paper §3): a set of keys with INSERT /
DELETE / SEARCH.  Batched step semantics (DESIGN.md §2): searches in a step
observe the pre-step snapshot; updates apply in batch order.
"""

from __future__ import annotations

import numpy as np

OP_SEARCH, OP_INSERT, OP_DELETE = 0, 1, 2


class SetOracle:
    def __init__(self, initial=()):
        self.s = set(int(x) for x in initial)

    def snapshot_search(self, keys) -> np.ndarray:
        snap = frozenset(self.s)
        return np.asarray([int(k) in snap for k in keys], dtype=bool)

    def apply_updates(self, kinds, keys) -> np.ndarray:
        out = np.zeros(len(keys), dtype=bool)
        for i, (k, v) in enumerate(zip(kinds, keys)):
            v = int(v)
            if k == OP_INSERT:
                out[i] = v not in self.s
                self.s.add(v)
            elif k == OP_DELETE:
                out[i] = v in self.s
                self.s.discard(v)
        return out

    def keys(self) -> np.ndarray:
        return np.asarray(sorted(self.s), dtype=np.int32)


class MapOracle:
    """key -> payload dictionary oracle (ΔTree map mode)."""

    def __init__(self, initial=()):
        self.d = {int(k): int(p) for k, p in initial}

    def snapshot_lookup(self, keys):
        snap = dict(self.d)
        found = np.asarray([int(k) in snap for k in keys], dtype=bool)
        pay = np.asarray([snap.get(int(k), -1) for k in keys], dtype=np.int32)
        return found, pay

    def apply_updates(self, kinds, keys, payloads) -> np.ndarray:
        out = np.zeros(len(keys), dtype=bool)
        for i, (k, v, p) in enumerate(zip(kinds, keys, payloads)):
            v, p = int(v), int(p)
            if k == OP_INSERT:
                out[i] = v not in self.d
                if out[i]:
                    self.d[v] = p
            elif k == OP_DELETE:
                out[i] = v in self.d
                self.d.pop(v, None)
        return out

    def items(self):
        return sorted(self.d.items())
