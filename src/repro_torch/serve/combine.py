"""Same-key op combining — the elimination pass at admission (DESIGN.md §10).

The port's own copy of ``repro.serve.combine`` (numpy and stdlib only).

The elimination (a,b)-trees line of work (PAPERS.md, Srivastava) shows
same-key operation pairs can annihilate *before* they reach the
structure: an insert immediately followed by a delete of the same key is
a no-op at the linearization boundary, and N identical lookups cost one
shard op plus a fan-out.  The serve scheduler stages every step's index
ops host-side and runs this pass once per step, so a hot key costs one
shard op instead of many.

``combine_ops`` operates under the pager's batch discipline (asserted at
apply time): within one staged batch an INSERT row always targets a key
absent from the index and a DELETE row a key present in it *or inserted
earlier in the same batch*.  Under that precondition an (INSERT k,
DELETE k) pair in batch order has no observable effect on any read after
the batch — the item is never visible at a step boundary — so dropping
both rows is a valid linearization.  Without the discipline the pair
would NOT be a no-op (an insert on a pre-existing key fails and the
delete then removes the *old* item), which is why this lives in the
serve layer and not inside the index.

Host-side numpy throughout: staged batches are small (a step's admission
+ growth + departures) and the pass runs once per step, off any jitted
path.
"""

from __future__ import annotations

import numpy as np

from repro_torch.api.opbatch import OP_DELETE, OP_INSERT, OP_SEARCH

__all__ = ["combine_ops", "dedupe_lookups"]


def combine_ops(kinds, keys, payloads):
    """Annihilate (INSERT k, DELETE k) pairs and collapse duplicate
    SEARCH rows within one staged batch.

    Returns ``(kinds, keys, payloads, combined)`` with the surviving rows
    in their original batch order; ``combined`` counts the rows
    eliminated.  Per key, update rows cancel as a stack in batch order —
    a DELETE annihilates the closest preceding uncancelled INSERT (the
    admitted-then-departed-same-step case; repeated join/leave on one key
    cancels pairwise) — and SEARCH rows keep only the first occurrence.
    """
    kinds = np.asarray(kinds, np.int32)
    keys = np.asarray(keys)
    payloads = np.asarray(payloads, np.int32)
    n = len(kinds)
    keep = np.ones(n, bool)
    open_inserts: dict = {}   # key -> stack of uncancelled INSERT rows
    seen_search: set = set()
    for i in range(n):
        k = int(keys[i])
        if kinds[i] == OP_INSERT:
            open_inserts.setdefault(k, []).append(i)
        elif kinds[i] == OP_DELETE:
            stack = open_inserts.get(k)
            if stack:
                keep[stack.pop()] = False
                keep[i] = False
        else:
            assert kinds[i] == OP_SEARCH, int(kinds[i])
            if k in seen_search:
                keep[i] = False
            seen_search.add(k)
    combined = int(n - keep.sum())
    return kinds[keep], keys[keep], payloads[keep], combined


def dedupe_lookups(keys):
    """Collapse duplicate lookup keys to one shard op each.

    Returns ``(unique_keys, inverse, combined)``: probe ``unique_keys``
    once, then ``result[inverse]`` restores the per-caller fan-out.
    ``combined`` counts the lookups eliminated."""
    keys = np.asarray(keys)
    uniq, inverse = np.unique(keys, return_inverse=True)
    return uniq, inverse, int(len(keys) - len(uniq))
