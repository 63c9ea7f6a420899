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
fused cross-shard frontier: no per-shard rows at all.  On one rank the
batch passes through in batch order, every lane seeded at its owner
shard's root in one base-offset arena view; on R ranks it bucket-sorts by
owner *rank* ((R, K) rows) and each rank fuses its own shards.

The shards spread over the ranks of the default ``torch.distributed``
process group, the counterpart of the JAX package's ``shard_map`` over the
"shards" mesh (R = the largest divisor of S that fits the world size,
`launch.mesh.forest_ranks`; `forest_mesh` gives the mesh itself to a
caller that needs one, and nothing here does).  Every rank runs the same program on the same batch (SPMD:
operands are replicated), holds the stacked arenas of its own S / R
shards only (`span`), runs their part, and all-gathers the parts, so
every rank returns the same batch-order result.  Ranks past R hold a
replica of position rank mod R.  Shards on one rank run one after another
(reads and updates alike).  With no process group, or one rank, R = 1 and
every shard is on this process.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import layout
from repro_torch.core.deltatree import resolve_device, shard_of
from repro_torch.launch.mesh import forest_ranks, make_forest_mesh, world
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


@functools.lru_cache(maxsize=None)
def _forest_mesh_cached(num_shards: int, world_size: int, device: str):
    del world_size  # cache key only: make_forest_mesh reads the live group
    return make_forest_mesh(num_shards, device=device)


def forest_mesh(num_shards: int, device=None):
    """The "shards" mesh for ``num_shards`` on ``device``'s type (the card
    by default), cached per (num_shards, world size, device type): a
    change of the process group within one process gets a fresh mesh
    instead of a stale cached one.  A mesh of more than one rank is
    made by every rank together (it creates process groups), so every rank
    calls this in the same order.  The forest's own paths read only its
    size, through `span`, and never build it."""
    return _forest_mesh_cached(num_shards, world()[1],
                               resolve_device(device).type)


class Span(NamedTuple):
    """This rank's part of the "shards" axis."""

    ranks: int   # R: mesh positions the shards spread over
    pos: int     # this rank's position (rank mod R)
    local: int   # shards a position holds: S / R

    @property
    def lo(self) -> int:
        """Global index of this rank's first shard."""
        return self.pos * self.local


def span(num_shards: int) -> Span:
    """The shards this rank holds: [lo, lo + local) of ``num_shards``."""
    r = forest_ranks(num_shards, world()[1])
    return Span(r, world()[0] % r, num_shards // r)


def gather_ranks(x, ranks: int):
    """Every mesh position's (n, ...) block of ``x``, concatenated in
    position order: (ranks * n, ...) on ``x``'s device.  ``x`` is a
    tensor or a tuple of tensors on one device sharing the leading n; a
    tuple goes in one all-gather, its rows' bytes side by side (each
    collective costs a host round trip, and a card shared by several
    processes makes those dear).  The all-gather runs over the default
    group (replicas past ``ranks`` are dropped); gloo moves a CUDA tensor
    through the host, NCCL a host tensor through the rank's card."""
    xs = x if isinstance(x, tuple) else (x,)
    n = xs[0].shape[0]
    widths = [math.prod(t.shape[1:]) * t.element_size() for t in xs]
    packed = torch.cat([t.contiguous().view(torch.uint8).reshape(n, w)
                        for t, w in zip(xs, widths)], 1)
    comm = "cuda" if dist.get_backend() == "nccl" else "cpu"
    y = packed.to(comm)
    parts = [torch.empty_like(y) for _ in range(world()[1])]
    dist.all_gather(parts, y)
    full = torch.cat(parts[:ranks]).to(packed.device)
    out, col = [], 0
    for t, w in zip(xs, widths):
        out.append(full[:, col:col + w].contiguous().view(t.dtype)
                   .reshape((ranks * n,) + t.shape[1:]))
        col += w
    return tuple(out) if isinstance(x, tuple) else out[0]


def gather_shards(num_shards: int, x: torch.Tensor) -> torch.Tensor:
    """A per-shard tensor of this rank's shards, (local, ...), as (S, ...)
    over every shard (the identity on one rank)."""
    sp = span(num_shards)
    return x if sp.ranks == 1 else gather_ranks(x, sp.ranks)


def _stack(outs: list):
    """Per-shard outputs -> one output: tensors stack to a leading (S,)
    axis, tuples recurse, anything else stays a list over shards."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if isinstance(first, tuple) and not hasattr(first, "_fields"):
        return tuple(_stack(list(col)) for col in zip(*outs))
    return outs


def _gather(out, ranks: int):
    """`_stack`'s output over this rank's shards -> over every shard, in
    one all-gather: a tensor, or a tuple of tensors and lists of
    per-shard records of ints (``MaintenanceStats``, gathered as int64
    rows)."""
    parts = out if isinstance(out, tuple) else (out,)
    dev = next((p.device for p in parts if isinstance(p, torch.Tensor)),
               None)
    got = gather_ranks(tuple(
        p if isinstance(p, torch.Tensor) else
        torch.tensor([list(o) for o in p], dtype=torch.int64, device=dev)
        for p in parts), ranks)
    back = tuple(g if isinstance(p, torch.Tensor) else
                 [type(p[0])(*row) for row in g.tolist()]
                 for p, g in zip(parts, got))
    return back if isinstance(out, tuple) else back[0]


def dispatch(num_shards: int, fn, trees, *dense_args):
    """Run ``fn(tree_s, *args_s)`` for every shard of this rank, one after
    another, and gather the outputs over the ranks.

    ``trees`` is this rank's stacked (S / R, ...) arena; ``tree_s`` is a
    DeltaTree of views of its rows (`deltatree.shard_of`), so an ``fn``
    that updates in place writes the stacked tensors.  Every
    ``dense_args`` tensor carries a leading (S,) axis over all shards.
    Tensor outputs stack to a leading (S,) axis; a tuple output is handled
    per element; other outputs come back as a list over the shards (on
    R ranks: records of ints, ``MaintenanceStats``)."""
    sp = span(num_shards)
    with TR.annotate("router.dispatch"):
        out = _stack([fn(shard_of(trees, j), *(a[sp.lo + j]
                                               for a in dense_args))
                      for j in range(sp.local)])
        return out if sp.ranks == 1 else _gather(out, sp.ranks)


def build_fused_view(num_shards: int, make_view, trees):
    """The fused base-offset view ``fused_dispatch`` would otherwise build
    per call (the engine's ``ForestBatch.make_view`` hook) over this
    rank's shards.  The forest layer caches it, keyed on the update
    epoch, and hands it back to read calls until the arena changes."""
    del num_shards  # ``trees`` is this rank's shards already
    with TR.annotate("router.fuse_view"):
        return make_view(trees)


def _leaves(fn, x):
    """``fn`` over a tensor or over each tensor of a tuple of them."""
    return tuple(fn(t) for t in x) if isinstance(x, tuple) else fn(x)


def fused_dispatch(num_shards: int, fn, trees, sid, keys, view=None):
    """Fused-frontier dispatch: one ``fn`` call per rank, over the
    base-offset fusion of its shards (DESIGN.md §8).

    ``fn(trees_loc, lid[K'], keys[K'], view_loc)`` sees this rank's
    stacked (S / R, ...) arenas, each lane's local shard index, the
    lanes' keys (or a tuple of per-lane columns) and ``view`` (this
    rank's `build_fused_view`; None: the hook builds it inline), and
    returns ``(lane_outs, shard_outs)``: lane outputs carry a leading
    (K',) axis, per-shard outputs a (S / R,) axis (or None).

    On one rank the batch passes through in batch order — no
    permutation, no dense scatter — and the routing returned is None.  On
    R ranks the batch bucket-sorts by owner rank (stable, so each rank's
    lanes keep batch order) into (R, K) dense rows padded with the
    born-resolved ROUTE_LEFT key (pad lanes end in round 0 and are never
    gathered); each rank runs its row and the lane outputs all-gather to
    (R, K, ...).  Returns (routing | None, lane_outs, shard_outs): map the
    lane outputs through ``gather_fused`` with the routing; the per-shard
    outputs come back over all S shards in shard order."""
    sp = span(num_shards)
    if sp.ranks == 1:
        with TR.annotate("router.fused"):
            lane, per_shard = fn(trees, sid, keys, view)
        return None, lane, per_shard
    sloc = sp.local
    with TR.annotate("router.fused"):
        r = route_by(torch.div(sid, sloc, rounding_mode="floor"), sp.ranks)
        lid = scatter_dense(r, sp.ranks, sid % sloc, 0)[sp.pos]
        # every leaf of ``keys`` (the scan sends (starts, his) columns)
        # scatters alike; the pad fill is the born-resolved sentinel
        row = _leaves(lambda x: scatter_dense(
            r, sp.ranks, x, int(layout.ROUTE_LEFT))[sp.pos], keys)
        lane, per_shard = fn(trees, lid, row, view)
        lane = gather_ranks(_leaves(lambda x: x[None], lane), sp.ranks)
        if per_shard is not None:
            per_shard = gather_ranks(per_shard, sp.ranks)
    return r, lane, per_shard


def gather_fused(r: Routing | None, lane_outs):
    """Batch-order view of ``fused_dispatch`` lane outputs: the identity
    when the batch was never permuted (one rank), else the rank-dense
    inverse permutation."""
    if r is None:
        return lane_outs
    return _leaves(lambda x: gather_batch(r, x), lane_outs)
