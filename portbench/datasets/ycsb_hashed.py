"""A YCSB table loaded with ``recordcount`` records, keyed by their hashed
record numbers (``insertorder=hashed``); row id = record index.  The next
``fresh`` records are held back for inserts.  The load does not depend on
the seed, as YCSB's does not."""

from __future__ import annotations

import numpy as np

from portbench.bench.data import Dataset
from portbench.traffic import ycsb


def make(spec: dict, rng, fresh: int) -> Dataset:
    n = int(spec["recordcount"])
    recs = ycsb.record_keys(n + fresh)
    ids = np.arange(recs.size, dtype=np.int64)
    order = np.argsort(recs[:n])
    return Dataset(keys=recs[:n][order], payloads=ids[:n][order],
                   key_max=ycsb.KEY_SPAN + 1, records=recs[:n],
                   record_ids=ids[:n], fresh_keys=recs[n:],
                   fresh_ids=ids[n:])
