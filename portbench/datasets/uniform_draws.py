"""The Fig. 12 tree's data (``benchmarks/fig12_big_tree.py``): ``draws``
uniform keys on [1, key_max), duplicates dropped, set mode."""

from __future__ import annotations

import numpy as np

from portbench.bench.data import Dataset


def make(spec: dict, rng, fresh: int) -> Dataset:
    key_max = int(spec["key_max"])
    keys = np.unique(rng.integers(1, key_max, size=int(spec["draws"]),
                                  dtype=np.int64))
    return Dataset(keys=keys, payloads=None, key_max=key_max)
