"""Batched cross-shard routing for the DeltaForest (port of
``repro.distributed.router``; DESIGN.md §4, §8).

A mixed query/update batch arrives in *linearization order*.  The dense
dispatch (updates; reads under engines without a fused entry point, or
with ``ForestConfig.fused`` off)

  1. assigns every op its owner shard with one ``searchsorted`` against the
     (S-1,) boundary tensor,
  2. bucket-sorts the batch by shard with one stable argsort (stability
     keeps batch order *within* each shard, which is what the per-shard
     linearization needs: ops on one key always land in one shard),
  3. computes segment offsets of the sorted shard ids (a second
     searchsorted) and scatters each op into a dense (S, K) per-shard row,
     padded with no-op rows (OP_SEARCH / the born-resolved ROUTE_LEFT key),
  4. runs the per-shard function on every shard (`dispatch`),
  5. inverse-permutes the (S, K) per-shard results back to batch order.

``fused_dispatch`` is the read path's alternative when the engine has a
fused cross-shard frontier: no per-shard rows at all — the batch passes
through in batch order, every lane seeded at its owner shard's root in
one base-offset arena view.

All shards live on one device here.  The JAX package spreads them over a
"shards" device mesh with ``shard_map``; this port has one card, so
`dispatch` is a loop over the shards on that device (reads and updates
alike run shard after shard) and there is no mesh.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.deltatree import shard_of
from repro_torch.obs import trace as TR


class Routing(NamedTuple):
    """Routing plan for one batch (all (K,) int32)."""

    sid: torch.Tensor         # owner bucket per op, batch order
    order: torch.Tensor       # stable permutation sorting ops by bucket
    sid_sorted: torch.Tensor  # sid[order]
    local: torch.Tensor       # lane within the owner bucket's dense row


def shard_ids(splits: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Owner shard per key: one searchsorted against the boundaries.

    The *boundaries* widen to the key dtype, never the reverse: an int64
    probe beyond the int32 range must not wrap before it is routed, or it
    lands on a bogus shard.  Splits always fit int32, so widening them is
    lossless."""
    return torch.searchsorted(splits.to(keys.dtype), keys.contiguous(),
                              right=True).to(torch.int32)


def route(splits: torch.Tensor, keys: torch.Tensor) -> Routing:
    """The bucket-sort plan: searchsorted + segment offsets."""
    return route_by(shard_ids(splits, keys), splits.shape[0] + 1)


def route_by(ids: torch.Tensor, num_buckets: int) -> Routing:
    """Bucket-sort plan over precomputed bucket ids (the stable argsort
    keeps batch order *within* each bucket — the per-bucket
    linearization).  ``route`` is this over owner shards."""
    k = ids.shape[0]
    dev = ids.device
    order = torch.argsort(ids, stable=True)
    ids_sorted = ids[order]
    # offsets[s] = first sorted index owned by bucket s (segment offsets)
    offsets = torch.searchsorted(
        ids_sorted, torch.arange(num_buckets, dtype=ids.dtype, device=dev),
        right=False).to(torch.int32)
    local = (torch.arange(k, dtype=torch.int32, device=dev)
             - offsets[ids_sorted.long()])
    return Routing(ids, order.to(torch.int32), ids_sorted, local)


def lane_counts(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Per-bucket lane counts of one routed batch ((num_buckets,) int32)."""
    out = torch.zeros(num_buckets, dtype=torch.int32, device=ids.device)
    return out.index_add_(0, ids.long(), torch.ones_like(ids))


def scatter_dense(r: Routing, num_shards: int, x: torch.Tensor,
                  fill) -> torch.Tensor:
    """Batch-order (K,) -> dense per-shard (S, K), padded with ``fill``."""
    k = x.shape[0]
    dense = torch.full((num_shards, k), fill, dtype=x.dtype, device=x.device)
    dense[r.sid_sorted.long(), r.local.long()] = x[r.order.long()]
    return dense


def gather_batch(r: Routing, dense: torch.Tensor) -> torch.Tensor:
    """Inverse permute dense per-shard (S, K, ...) results to batch order."""
    k = r.order.shape[0]
    picked = dense[r.sid_sorted.long(), r.local.long()]
    out = torch.zeros((k,) + dense.shape[2:], dtype=dense.dtype,
                      device=dense.device)
    out[r.order.long()] = picked
    return out


def _stack(outs: list):
    """Per-shard outputs -> one output: tensors stack to a leading (S,)
    axis, tuples recurse, anything else stays a list over shards."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if isinstance(first, tuple) and not hasattr(first, "_fields"):
        return tuple(_stack(list(col)) for col in zip(*outs))
    return outs


def dispatch(num_shards: int, fn, trees, *dense_args):
    """Run ``fn(tree_s, *args_s)`` for every shard, one after another.

    ``trees`` is the stacked (S, ...) arena; ``tree_s`` is a DeltaTree of
    views of its rows (`deltatree.shard_of`), so an ``fn`` that updates in
    place writes the stacked tensors.  Every ``dense_args`` tensor carries
    a leading S axis.  Tensor outputs stack to a leading (S,) axis; a
    tuple output is handled per element; other outputs (a tree, stats)
    come back as a list over the shards."""
    with TR.annotate("router.dispatch"):
        outs = [fn(shard_of(trees, s), *(a[s] for a in dense_args))
                for s in range(num_shards)]
    return _stack(outs)


def build_fused_view(num_shards: int, make_view, trees):
    """The fused base-offset view ``fused_dispatch`` would otherwise build
    per call (the engine's ``ForestBatch.make_view`` hook).  The forest
    layer caches it, keyed on the update epoch, and hands it back to read
    calls until the arena changes."""
    del num_shards  # every shard is on this one device
    with TR.annotate("router.fuse_view"):
        return make_view(trees)


def fused_dispatch(num_shards: int, fn, trees, sid, keys, view=None):
    """Fused-frontier dispatch: one ``fn`` call over the base-offset fusion
    of every shard (DESIGN.md §8).

    ``fn(trees, sid[K], keys[K], view)`` sees the stacked (S, ...) arenas,
    each lane's owner shard, the lanes' keys (or a tuple of per-lane
    columns) and ``view`` (None: the hook builds it inline), and returns
    ``(lane_outs, shard_outs)``: lane outputs carry a leading (K,) axis,
    per-shard outputs an (S,) axis (or None).  The batch passes through in
    batch order — no permutation, no dense scatter — so the returned
    routing is None.  Returns (None, lane_outs, shard_outs)."""
    del num_shards
    with TR.annotate("router.fused"):
        lane, per_shard = fn(trees, sid, keys, view)
    return None, lane, per_shard


def gather_fused(r: Routing | None, lane_outs):
    """Batch-order view of ``fused_dispatch`` lane outputs.  On one device
    the batch was never permuted (``r`` is None), so this is the
    identity; the JAX package's multi-device branch inverse-permutes."""
    assert r is None, "a fused dispatch on one device does not permute"
    return lane_outs
