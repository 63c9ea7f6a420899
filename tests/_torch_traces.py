"""Op sequences that `tests/test_torch_property.py` runs through the JAX
package and the port, and `chip_smoke.py` replays on the card against the
port on the CPU.  Numpy only: no torch, no JAX.

- `seeded_sequences`: JAX's property strategy (1-5 batches of 1-12
  inserts / deletes of keys 1-40) drawn from a numpy seed, each batch
  padded by `pad` to WIDTH with trailing searches.
- KEEP_TRACES: committed traces in which an Expand keeps an item
  (`deltatree._process_ins`: a buffered value whose descent lands in a
  child whose buffer is full), under ``eager`` and ``budgeted:2``.
"""

from __future__ import annotations

import numpy as np

OP_SEARCH, OP_INSERT, OP_DELETE = 0, 1, 2
I, D = OP_INSERT, OP_DELETE

WIDTH = 12          # every batch padded to this width with trailing searches
SEQUENCES = 12      # op sequences a configuration
SEQ_CFG = dict(max_dnodes=256, buf_cap=4)
# (policy, engine, height): each (policy, engine) pair once, each height
# under two pairs
SEQ_CONFIGS = [
    ("eager", "scalar", 3), ("eager", "lockstep", 4),
    ("deferred", "scalar", 5), ("deferred", "lockstep", 3),
    ("budgeted:2", "scalar", 4), ("budgeted:2", "lockstep", 5),
]
POLICIES = ("eager", "deferred", "budgeted:2")
ENGINES = ("scalar", "lockstep")


def seq_seed(policy: str, engine: str, height: int) -> int:
    return 1000 * height + 10 * POLICIES.index(policy) + ENGINES.index(engine)


def seeded_sequences(seed: int) -> list:
    """SEQUENCES lists of 1-5 (kinds, keys) batches of 1-12 ops each,
    kinds insert / delete, keys 1-40, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(SEQUENCES):
        seq = []
        for _ in range(int(rng.integers(1, 6))):
            k = int(rng.integers(1, WIDTH + 1))
            seq.append((rng.integers(1, 3, k).astype(np.int32),
                        rng.integers(1, 41, k).astype(np.int32)))
        out.append(seq)
    return out


def pad(kinds, keys, width: int = WIDTH):
    """Trailing searches up to ``width``: the update step takes no search,
    and rows after every update cannot shadow one (the fast path's
    conflicts go to the earlier row)."""
    n = width - kinds.size
    return (np.concatenate([kinds, np.full(n, OP_SEARCH, np.int32)]),
            np.concatenate([keys, np.ones(n, np.int32)]))


# Both traces start from bulk_build(100, 200, ..., 1900) at height 3 with
# one-slot buffers and a round cap of 1.  The round cap is what lets a
# merge run under a parent that still buffers an item: with the default
# cap, eager drains every buffer before a batch returns (each round's
# sweep takes every flagged ΔNode, none holding more than this batch's
# inserts), and budgeted defers a merge under a buffered parent.  A keep
# needs that merge: it re-routes the parent's buffered item into the
# merged child, whose buffer a later insert fills.
KEEP_INIT = np.arange(100, 2000, 100, dtype=np.int32)
KEEP_CFG = dict(height=3, max_dnodes=64, buf_cap=1, max_rounds=1,
                engine="lockstep")
KEEP_TRACES = {
    # P = node 5 (1100, 1200) grows a child D (node 21) at its slot 0 and
    # buffers 1170; the lower nodes 1 and 3 (freed by merges, reused by two
    # Expands) take the one-repair sweeps of the next two batches, so D
    # merges while P still buffers 1170; then 1160 / 1180 / 1190 fill D's
    # buffer and P's Expand keeps 1170.  Its one-op batches need their
    # one-repair sweeps, so only the two-insert batch is padded (to 3).
    "eager": [
        [(I, 1150)], [(I, 1120)], [(D, 100)], [(D, 200)], [(D, 500)],
        [(D, 600)], [(I, 950)], [(I, 1350)], [(D, 1100)],
        [(I, 920), (I, 1320), (OP_SEARCH, 1)], [(I, 1170)], [(D, 1120)],
        [(I, 1160), (I, 1180), (I, 1190)],
    ],
    # P = node 21 (a child of node 7) grows a child D (node 22); the big
    # batch buffers 1515 in P, deletes D's keys and leaves node 4 flagged
    # past the two voluntary repairs; a one-repair flush sweeps node 4 and
    # merges D under the buffered P; then 1512 / 1514 / 1513 fill D's
    # buffer and P's voluntary Expand keeps 1515 (residual).  Every batch
    # is padded to 6.
    "budgeted:2": [
        [(I, 1550)], [(I, 1520)], [(I, 150)], [(I, 550)], [(I, 950)],
        [(I, 1510)], [(I, 1505)], [(OP_SEARCH, 1)],
        [(I, 1515), (I, 120), (I, 520), (I, 920), (D, 1500), (D, 1505)],
        "flush",
        [(I, 1512), (I, 1514), (I, 1513)],
    ],
}
KEEP_PAD = {"eager": None, "budgeted:2": 6}
# (step, parent ΔNode, the item it keeps) of each trace's one keep
KEEP_AT = {"eager": (12, 5, 1170), "budgeted:2": (10, 21, 1515)}


def keep_steps(policy: str):
    """KEEP_TRACES[policy] as (kinds, keys) arrays, padded per KEEP_PAD,
    and "flush" (a one-repair flush) where the trace has one."""
    for batch in KEEP_TRACES[policy]:
        if batch == "flush":
            yield batch
            continue
        kinds = np.asarray([k for k, _ in batch], np.int32)
        keys = np.asarray([v for _, v in batch], np.int32)
        yield pad(kinds, keys, KEEP_PAD[policy]) if KEEP_PAD[policy] \
            else (kinds, keys)
