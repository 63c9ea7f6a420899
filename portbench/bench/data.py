"""The data a configuration deploys, made from the seed: its initial keys
and payloads, the key range its uniform draws span, and for a YCSB table
the records in insertion order and the fresh records inserts take.

A configuration file's ``data.kind`` names the maker:
``portbench/datasets/<kind>.py``, whose ``make(spec, rng, fresh)`` returns
a `Dataset`.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np


@dataclasses.dataclass
class Dataset:
    keys: np.ndarray              # initial keys, sorted, unique (int64)
    payloads: np.ndarray | None   # their payloads (int64), None in set mode
    key_max: int                  # uniform draws span [1, key_max)
    records: np.ndarray | None = None   # record keys in insertion order
    record_ids: np.ndarray | None = None  # each record's row id
    fresh_keys: np.ndarray | None = None  # keys of records not yet inserted
    fresh_ids: np.ndarray | None = None   # their row ids

    @property
    def size(self) -> int:
        return int(self.keys.size)


def make(config: dict, rng, fresh: int = 0) -> Dataset:
    spec = config["data"]
    maker = importlib.import_module(f"portbench.datasets.{spec['kind']}")
    return maker.make(spec, rng, fresh)
