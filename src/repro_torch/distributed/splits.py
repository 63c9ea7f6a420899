"""Key-range partitioner for the DeltaForest (port of
``repro.distributed.splits``; DESIGN.md §4).

Shard boundaries follow the *observed* key distribution: given a key
sample, ``equidepth_splits`` places the S-1 boundaries at equi-depth
quantiles so every shard owns the same number of sampled keys.  Shard
ownership is

    shard(k) = #{ j : splits[j] <= k }       (torch.searchsorted right=True)

i.e. shard 0 owns keys below ``splits[0]`` and shard j owns
``[splits[j-1], splits[j])``.  Boundaries are strictly increasing;
degenerate samples fall back to equi-width boundaries over the key domain.

The partition is chosen on the host with numpy (this module is the port's
own copy of the JAX one, which is numpy too), then kept in the forest as a
small (S-1,) int32 tensor that the router searchsorts against.
``rebalance`` re-derives boundaries from the *live* key set and rebuilds
the forest when growth has skewed the shards; over several ranks every
rank derives the same boundaries and builds its own shards.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import layout
from repro_torch.distributed import router as R


def equiwidth_splits(num_shards: int, key_min: int = layout.KEY_MIN,
                     key_max: int = layout.KEY_MAX) -> np.ndarray:
    """Uniform boundaries over [key_min, key_max] (no-sample fallback)."""
    assert num_shards >= 1
    span = int(key_max) - int(key_min) + 1
    bnd = key_min + (np.arange(1, num_shards, dtype=np.int64) * span) // num_shards
    return bnd.astype(np.int64)


def equidepth_splits(sample: np.ndarray, num_shards: int,
                     key_min: int = layout.KEY_MIN,
                     key_max: int = layout.KEY_MAX) -> np.ndarray:
    """Equi-depth boundaries from a key sample.

    Returns (num_shards - 1,) strictly increasing boundaries.  Quantile
    positions that collide (tiny or highly skewed samples) are repaired
    from the equi-width grid so the router always sees a valid partition.
    """
    assert num_shards >= 1
    if num_shards == 1:
        return np.zeros((0,), np.int64)
    sample = np.sort(np.asarray(sample, np.int64).ravel())
    fallback = equiwidth_splits(num_shards, key_min, key_max)
    if sample.size == 0:
        return fallback
    # boundary j = smallest key of shard j+1 -> the (j+1)*n/S-th sample
    idx = ((np.arange(1, num_shards, dtype=np.int64) * sample.size)
           // num_shards)
    bnd = sample[np.clip(idx, 0, sample.size - 1)]
    # enforce strict monotonicity inside (key_min, key_max]
    out = np.empty(num_shards - 1, np.int64)
    prev = int(key_min)
    for j in range(num_shards - 1):
        b = int(max(bnd[j], prev + 1))
        b = min(b, int(key_max))
        out[j] = b
        prev = b
    # if we saturated at key_max, spread the tail from the equi-width grid
    for j in range(num_shards - 2, -1, -1):
        hi = int(key_max) - (num_shards - 2 - j)
        if out[j] > hi:
            out[j] = hi
    if (np.diff(out) <= 0).any():
        return fallback
    return out


def shard_of_np(splits: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Host-side shard ownership (mirrors the router's searchsorted)."""
    return np.searchsorted(np.asarray(splits, np.int64),
                           np.asarray(keys, np.int64), side="right")


def shard_counts(fcfg, forest) -> np.ndarray:
    """Live keys per shard over every rank (host-side).  Buffers are empty
    post-step (invariant I5), so per-arena ``nlive`` over alive ΔNodes is
    exact."""
    t = forest.trees
    local = torch.where(t.alive, t.nlive, 0).sum(1, dtype=torch.int64)
    return R.gather_shards(fcfg.num_shards, local).cpu().numpy()


def needs_rebalance(fcfg, forest, *, skew: float = 2.0) -> bool:
    """True when the fullest shard holds > ``skew`` times its fair share.

    The worst case with S shards is S times the mean, so the effective
    threshold is clamped to (S+1)/2 — strictly below S — ensuring maximal
    skew always trips regardless of shard count (S=2 included)."""
    counts = shard_counts(fcfg, forest)
    total = counts.sum()
    if total == 0 or len(counts) <= 1:
        return False
    eff = min(skew, (len(counts) + 1) / 2)
    return bool(counts.max() > eff * (total / len(counts)))


def rebalance(fcfg, forest):
    """Re-partition the forest equi-depth over its *live* keys and rebuild
    it on the same device.

    Slow path by design (a host-side gather of the live items from every
    rank, then a bulk build in which each rank builds its own shards):
    maintenance stays shard-local; this is the forest-level analogue of a
    Rebalance sweep, run rarely when ``needs_rebalance`` trips.  Returns a
    new Forest; the old one is left as it was.
    """
    from repro_torch.distributed import forest as F

    items = F.live_items(fcfg, forest)
    keys = np.asarray([k for k, _ in items], np.int64)
    pays = np.asarray([p for _, p in items], np.int64)
    new_splits = equidepth_splits(keys, fcfg.num_shards,
                                  fcfg.key_min, fcfg.key_max)
    return F.bulk_build(fcfg, keys, pays if fcfg.tree.payload_bits else None,
                        splits=new_splits, device=forest.splits.device)
