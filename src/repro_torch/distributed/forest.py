"""DeltaForest — S independent ΔTree arenas partitioned by key range (port
of ``repro.distributed.forest``; DESIGN.md §4, §8).

The forest is the scale-out layer over `repro_torch.core`: each shard is a
full ΔTree arena owning a contiguous key range, and the shards' arenas are
stacked into one ``DeltaTree`` whose tensors carry a leading (S,) axis.
The API is a superset of the single tree's:

    ForestConfig, Forest, empty, bulk_build,
    search_batch, lookup_batch, update_batch, successor_jit, scan_batch,
    successor_k, flush, live_keys, live_items

Semantics are those of one tree: the router's stable bucket sort keeps
batch order within each shard, and ops on one key always route to one
shard, so per-shard batch-order application is a valid linearization of
the whole batch.  Maintenance (Rebalance / Expand / Merge) runs shard by
shard and never crosses shards.

Reads take one of two dispatches: the dense per-shard dispatch (always for
updates; for reads when the engine has no fused entry point or
``ForestConfig.fused`` is off) or the *fused* cross-shard frontier — the
shard arenas seen as one base-offset arena, every query seeded at its
owner shard's root, one walk launch for the whole routed batch.  Both give
the same found/payload/succ and per-query hops, bit for bit.

Cross-shard coordination exists in one read-only place: a successor query
whose owner shard has no key above it falls through to the first later
non-empty shard's minimum.  The per-shard minima come from the same
dispatch (one extra successor probe per shard) and are combined with a
suffix minimum.

The shards spread over the ranks of the default ``torch.distributed``
process group as the JAX forest's spread over its "shards" device mesh
(`router.span`: R ranks): each rank holds the stacked arenas of its own
S / R shards (``trees``) on its ``device``, while ``splits``, the per-shard
counters and ``epoch`` are replicated; every entry point is called by
every rank with the same arguments and returns the same result on each.
With no process group every shard is on this process.

What differs from the JAX package:

- Shards on one rank run one after another (the JAX forest vmaps reads
  over a device's shards).
- Updates write the arenas **in place**, as the single-tree port does.
  `update_batch` hands each shard's maintenance a tree of views of the
  stacked tensors (`shard_tree`), so every write lands in the forest.  The
  returned Forest shares the arenas with the one passed in.
- ``epoch`` is a host int.  It counts arena mutations and keys the fused
  view cache; the cache also checks that the arena's link tensors were
  not written since the view was built.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import deltatree as DT
from repro_torch.core import engine as E
from repro_torch.core import layout
from repro_torch.core.deltatree import DeltaTree, TreeConfig
from repro_torch.distributed import router as R
from repro_torch.distributed import splits as SP
from repro_torch.maintenance.stats import MaintenanceStats

OP_SEARCH, OP_INSERT, OP_DELETE = DT.OP_SEARCH, DT.OP_INSERT, DT.OP_DELETE

_NO_SUCC = 2**31 - 1  # suffix-min identity for absent shard minima


@dataclasses.dataclass(frozen=True)
class ForestConfig:
    """Static forest parameters (hashable).

    num_shards: S — number of independent ΔTree arenas.
    tree:       per-shard TreeConfig (arena size is *per shard*; its
                ``engine`` picks the SearchEngine of every shard's reads).
    key_min/max: key domain of the fallback equi-width boundaries.
    fused:      use the engine's fused cross-shard frontier when it has
                one; False pins reads to the dense per-shard dispatch (the
                reference the fused path is held against).
    """

    num_shards: int = 4
    tree: TreeConfig = TreeConfig()
    key_min: int = layout.KEY_MIN
    key_max: int = layout.KEY_MAX
    fused: bool = True


class Forest(NamedTuple):
    """Stacked arenas: every DeltaTree tensor gains a leading axis over
    this rank's S / R shards (all S on one rank); ``splits`` is the (S-1,)
    int32 boundary tensor the router searchsorts.

    ``reads`` / ``updates`` are cumulative per-shard (S,) int32 op counters
    (`shard_load`).  Updates count inside `update_batch`; reads count only
    when the caller folds a batch in with `record_reads`.

    ``epoch`` (host int) is the arena-mutation counter: bumped by every
    `update_batch` / `flush`, kept by `record_reads`.  It keys the fused
    view cache."""

    trees: DeltaTree
    splits: torch.Tensor
    reads: torch.Tensor
    updates: torch.Tensor
    epoch: int


def _stack(trees: list[DeltaTree]) -> DeltaTree:
    return DeltaTree(*(torch.stack(xs) for xs in zip(*trees)))


def shard_tree(forest: Forest, s: int) -> DeltaTree:
    """This rank's shard ``s`` (global shard ``router.span(S).lo + s``) as
    a DeltaTree of views of the stacked tensors (`deltatree.shard_of`):
    reads see the forest, in-place writes change it."""
    return DT.shard_of(forest.trees, s)


def _as_splits(fcfg: ForestConfig, splits, device) -> torch.Tensor:
    if splits is None:
        splits = SP.equiwidth_splits(fcfg.num_shards, fcfg.key_min,
                                     fcfg.key_max)
    splits = np.asarray(splits, np.int64)
    assert splits.shape == (fcfg.num_shards - 1,), splits.shape
    return torch.as_tensor(splits.astype(np.int32), device=device)


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------


def _new(fcfg: ForestConfig, shards: list[DeltaTree], splits,
         device) -> Forest:
    """A forest from per-shard trees built on the host: one stack, one
    copy to ``device``."""
    trees = DeltaTree(*(x.to(device) for x in _stack(shards)))
    zeros = torch.zeros(fcfg.num_shards, dtype=torch.int32, device=device)
    return Forest(trees=trees, splits=_as_splits(fcfg, splits, device),
                  reads=zeros, updates=zeros.clone(), epoch=0)


def empty(fcfg: ForestConfig, splits=None, device=None) -> Forest:
    """An empty forest on ``device`` (``cuda`` when None); this rank's
    shards only."""
    dev = DT.resolve_device(device)
    shards = [DT.empty(fcfg.tree, "cpu")
              for _ in range(R.span(fcfg.num_shards).local)]
    return _new(fcfg, shards, splits, dev)


def bulk_build(fcfg: ForestConfig, values: np.ndarray,
               payloads: np.ndarray | None = None, splits=None,
               device=None) -> Forest:
    """Build a forest from unique keys on the host, then move it to
    ``device`` (``cuda`` when None).  Every rank splits the same keys the
    same way and builds its own shards only.

    With no explicit ``splits`` the boundaries are equi-depth over
    ``values``: every shard starts with |values|/S keys whatever the key
    distribution."""
    dev = DT.resolve_device(device)
    values = np.asarray(values, np.int64)
    order = np.argsort(values)
    values = values[order]
    if payloads is not None:
        payloads = np.asarray(payloads, np.int64)[order]
    if splits is None:
        splits = SP.equidepth_splits(values, fcfg.num_shards,
                                     fcfg.key_min, fcfg.key_max)
    splits = np.asarray(splits, np.int64)
    sid = SP.shard_of_np(splits, values)
    sp = R.span(fcfg.num_shards)
    shards = []
    for s in range(sp.lo, sp.lo + sp.local):
        mask = sid == s
        shards.append(DT.bulk_build(
            fcfg.tree, values[mask],
            payloads[mask] if payloads is not None else None, "cpu"))
    return _new(fcfg, shards, splits, dev)


# --------------------------------------------------------------------------
# wait-free reads
# --------------------------------------------------------------------------

# dense pad-lane key: the reserved ROUTE_LEFT sentinel — it matches no
# stored key and makes lockstep pad lanes born resolved (round 0, no
# successor chase)
_PAD_KEY = int(layout.ROUTE_LEFT)


def _route_keys(keys, device) -> torch.Tensor:
    """Clamp query keys to the int32 key domain *in the caller's dtype*,
    then cast: an int64 probe beyond the int32 range would otherwise wrap
    before the searchsorted and route to (and walk in) the wrong shard.
    Below-domain probes clamp to KEY_MIN-1 = 0 (never stored; successor =
    global minimum), above-domain probes to the reserved ROUTE_LEFT
    sentinel (never stored; no successor)."""
    keys = torch.as_tensor(keys, device=device)
    return keys.clamp(0, _PAD_KEY).to(torch.int32)


def _fused(fcfg: ForestConfig):
    """The engine's fused forest entry point when enabled, else None."""
    return E.forest_batch(fcfg.tree) if fcfg.fused else None


# ---- the fused view cache --------------------------------------------------
#
# The fused dispatch's base-offset view (`ForestBatch.make_view` ->
# `kernels.veb_search.fuse_arenas`) is derived from the arenas; read loops
# over an unchanged forest (the serve decode loop) would rebuild it on
# every call.  The read wrappers look it up in a small host-side LRU keyed
# on ``(fcfg, epoch)``: every update_batch / flush starts a new view, as in
# the JAX package, so ``view_builds`` / ``view_hits`` count as its
# scheduler's do.  The epoch cannot see two things, so an entry also holds
# the arena it was built from and the version counters of the links it
# copied: another forest at the same epoch (a copy, a fresh build), and
# an older handle whose arena has since been written in place by an
# update (the handle keeps its old epoch, the links have moved).

_VIEW_CACHE_CAP = 4  # distinct (fcfg, forest) streams kept warm at once
_VIEW_CACHE: collections.OrderedDict = collections.OrderedDict()
_VIEW_STATS = {"builds": 0, "hits": 0}


def _links_version(trees: DeltaTree) -> tuple:
    return (trees.child._version, trees.parent._version, trees.root._version)


def _maybe_cached_view(fcfg: ForestConfig, f: Forest):
    """The cached fused view for ``f`` (built and cached on a miss), or
    None when the fused dispatch is off."""
    fb = _fused(fcfg)
    if fb is None:
        return None
    key = (fcfg, int(f.epoch))
    ent = _VIEW_CACHE.get(key)
    if (ent is not None and ent[0] is f.trees
            and ent[1] == _links_version(f.trees)):
        _VIEW_STATS["hits"] += 1
        _VIEW_CACHE.move_to_end(key)
        return ent[2]
    view = R.build_fused_view(fcfg.num_shards,
                              lambda t: fb.make_view(fcfg.tree, t), f.trees)
    _VIEW_STATS["builds"] += 1
    # one live view per fcfg: a rebuild means the arena moved on (an update
    # or another forest), so the old view is dead weight worth dropping now
    for stale in [k for k in _VIEW_CACHE if k[0] == fcfg]:
        del _VIEW_CACHE[stale]
    _VIEW_CACHE[key] = (f.trees, _links_version(f.trees), view)
    while len(_VIEW_CACHE) > _VIEW_CACHE_CAP:
        _VIEW_CACHE.popitem(last=False)
    return view


def fused_view_cache_stats() -> dict:
    """Host-side cache counters: cumulative builds and hits since process
    start or the last reset, and the current size."""
    return {"builds": _VIEW_STATS["builds"], "hits": _VIEW_STATS["hits"],
            "size": len(_VIEW_CACHE)}


def reset_fused_view_cache() -> None:
    _VIEW_CACHE.clear()
    _VIEW_STATS["builds"] = 0
    _VIEW_STATS["hits"] = 0


def search_batch(fcfg: ForestConfig, f: Forest, keys):
    """Routed wait-free search.  Returns (found[K], hops[K]), plus a
    trailing `ReadStats` when ``fcfg.tree.collect_stats`` is on."""
    found, _, hops, *stats = _lookup(fcfg, f, keys)
    return (found, hops, *stats)


def lookup_batch(fcfg: ForestConfig, f: Forest, keys):
    """Routed map-mode lookup.  Returns (found[K], payload[K], hops[K]),
    plus a trailing `ReadStats` when ``fcfg.tree.collect_stats`` is on."""
    return _lookup(fcfg, f, keys)


def _forest_read_stats(fcfg: ForestConfig, f: Forest, raw, keys, sid,
                       found, hops):
    """Forest `ReadStats` from batch-order read columns.

    Computed on the batch-order (found, hops), so both dispatches (fused
    frontier / dense per-shard) give the same stats bit for bit.  The
    router leg adds per-shard lane counts and how many caller keys the
    key-domain clamp (`_route_keys`) rewrote."""
    from repro_torch.obs.stats import ReadStats, RouterStats, SearchStats

    pad = keys == _PAD_KEY
    sp = R.span(fcfg.num_shards)
    member = R.gather_shards(fcfg.num_shards, torch.stack([
        DT.buffered_member(fcfg.tree, shard_tree(f, j), keys)
        for j in range(sp.local)]))
    # each lane's buffered membership in its owner shard
    lanes = torch.arange(keys.shape[0], device=keys.device)
    bhit = found & member[sid.long(), lanes]
    clamped = torch.sum(raw != keys.to(raw.dtype), dtype=torch.int32)
    transfers = None
    if E.collecting_transfers(fcfg.tree):
        from repro_torch.obs import transfers as OTR

        # shard-local replay from (stacked arenas, owner sid, keys): both
        # dispatches hand it the same sid, so their transfer stats agree.
        # A rank replays the lanes its shards own (the others as sentinel
        # lanes, which touch nothing); the per-lane columns sum over ranks
        own = (sid >= sp.lo) & (sid < sp.lo + sp.local)
        lsid = torch.where(own, sid - sp.lo, 0)
        cols = OTR.transfer_cols(
            fcfg.tree, f.trees.value, f.trees.child,
            f.trees.root[lsid.long()], lsid, torch.where(own, keys, _PAD_KEY))
        if sp.ranks > 1:
            cols = [c.sum(0, dtype=c.dtype) for c in R.gather_ranks(
                tuple(c[None] for c in cols), sp.ranks)]
        transfers = OTR.TransferStats.of(pad, *cols)
    return ReadStats(
        search=SearchStats.of(hops, pad, bhit),
        router=RouterStats.of(R.lane_counts(sid, fcfg.num_shards), clamped),
        transfers=transfers)


def _lookup(fcfg: ForestConfig, f: Forest, keys):
    raw = torch.as_tensor(keys, device=f.splits.device)
    keys = _route_keys(raw, f.splits.device)
    fb = _fused(fcfg)
    if fb is not None:
        # fused frontier: batch order end to end, one walk launch across
        # every shard (no (S, K) dense scatter)
        sid = R.shard_ids(f.splits, keys)

        def whole(trees, lid, ks, view):
            return fb.lookup(fcfg.tree, trees, lid, ks, view=view), None

        r, lane, _ = R.fused_dispatch(fcfg.num_shards, whole, f.trees, sid,
                                      keys, view=_maybe_cached_view(fcfg, f))
        found, pay, hops = R.gather_fused(r, lane)
    else:
        r = R.route(f.splits, keys)
        sid = r.sid
        dkeys = R.scatter_dense(r, fcfg.num_shards, keys, _PAD_KEY)
        # the bare engine hook: stats derive once below, from batch-order
        # columns, not per shard
        found, pay, hops = R.dispatch(
            fcfg.num_shards, lambda t, ks: E.lookup_cols(fcfg.tree, t, ks),
            f.trees, dkeys)
        found, pay, hops = (R.gather_batch(r, found), R.gather_batch(r, pay),
                            R.gather_batch(r, hops))
    if not E.collecting(fcfg.tree):
        return found, pay, hops
    return found, pay, hops, _forest_read_stats(fcfg, f, raw, keys, sid,
                                                found, hops)


def _succ_combine(sid, f_owner, s_owner, has_min, mins):
    """Cross-shard successor combine: the first non-empty shard strictly
    after each owner shard (a suffix minimum over shard minima works
    because shards are key-ordered); shared by both dispatch paths."""
    big = torch.full_like(mins, _NO_SUCC)
    masked = torch.where(has_min, mins, big)
    suffix = torch.flip(torch.cummin(torch.flip(masked, [0]), 0).values, [0])
    after = torch.cat([suffix[1:], big[:1]])
    fallback = after[sid.long()]
    has_fb = fallback < _NO_SUCC
    out_found = f_owner | has_fb
    out_succ = torch.where(f_owner, s_owner,
                           torch.where(has_fb, fallback, 0))
    return out_found, out_succ


def successor_jit(fcfg: ForestConfig, f: Forest, keys):
    """Routed wait-free successor.  Returns (found[K], succ[K]).

    An owner-shard miss falls through to the first later non-empty shard's
    minimum (probed in the same dispatch, combined with a suffix min).
    The name follows the JAX package, where this call is jitted."""
    keys = _route_keys(keys, f.splits.device)
    fb = _fused(fcfg)
    if fb is not None:
        sid = R.shard_ids(f.splits, keys)

        def whole(trees, lid, ks, view):
            found, succ, has_min, mins = fb.successor(fcfg.tree, trees, lid,
                                                      ks, view=view)
            return (found, succ), (has_min, mins)

        r, lane, (has_min, mins) = R.fused_dispatch(
            fcfg.num_shards, whole, f.trees, sid, keys,
            view=_maybe_cached_view(fcfg, f))
        f_owner, s_owner = R.gather_fused(r, lane)
        return _succ_combine(sid, f_owner, s_owner, has_min, mins)
    r = R.route(f.splits, keys)
    dkeys = R.scatter_dense(r, fcfg.num_shards, keys, _PAD_KEY)

    def per_shard(t, ks):
        # shard minimum = successor of (KEY_MIN - 1), as one extra lane of
        # the shard's batch (lanes are independent, so results are
        # unchanged and the walk is shared)
        probe = torch.cat([ks, torch.full((1,), layout.KEY_MIN - 1,
                                          dtype=torch.int32,
                                          device=ks.device)])
        found, succ = DT.successor_batch(fcfg.tree, t, probe)
        return found[:-1], succ[:-1], found[-1], succ[-1]

    found, succ, has_min, mins = R.dispatch(fcfg.num_shards, per_shard,
                                            f.trees, dkeys)
    return _succ_combine(r.sid, R.gather_batch(r, found),
                         R.gather_batch(r, succ), has_min, mins)


# --------------------------------------------------------------------------
# ordered bulk reads (range scan / successor_k)
# --------------------------------------------------------------------------


def scan_batch(fcfg: ForestConfig, f: Forest, starts, his, *,
               max_items: int):
    """Routed wait-free range scan: per lane, up to ``max_items`` live
    items with ``start < key <= hi`` in *global* key order.

    Returns the engine `scan` contract — (out (K, max_items) packed
    ascending with sentinel padding, n (K,), hops (K,), more (K,) bool).
    A range can span shards, so every lane is scanned against every shard
    (one emit-cursor lane per (lane, shard) pair — still one scan launch
    under the fused frontier); shards partition the key space in split
    order, so the per-shard bands concatenate sorted and the first
    ``max_items`` of the union are the correct page even when an early
    shard's band truncated.  ``hops`` is the lane's ΔNode visits summed
    over all shards."""
    return _scan(fcfg, f, starts, his, max_items)


def successor_k(fcfg: ForestConfig, f: Forest, keys, k: int):
    """Routed bulk successors: the ``k`` smallest live keys strictly
    greater than each query, forest-wide (the `scan_batch` contract)."""
    keys = torch.as_tensor(keys, dtype=torch.int32, device=f.splits.device)
    his = torch.full_like(keys, layout.KEY_MAX)
    return _scan(fcfg, f, keys, his, k)


def _scan(fcfg: ForestConfig, f: Forest, starts, his, max_items: int):
    cfg = fcfg.tree
    dev = f.splits.device
    starts = _route_keys(starts, dev)
    his = _route_keys(his, dev)
    s = fcfg.num_shards
    k = starts.shape[0]
    fb = _fused(fcfg)
    if fb is not None:
        # (lane, shard) tiling, shard-major: tiled lane s*k + i scans lane
        # i's band inside shard s, seeded at that shard's fused root
        sid = torch.arange(s, dtype=torch.int32,
                           device=dev).repeat_interleave(k)

        def whole(trees, lid, bounds, view):
            st, hb = bounds
            return fb.scan(cfg, trees, lid, st, hb, max_items,
                           view=view), None

        r, lane, _ = R.fused_dispatch(
            s, whole, f.trees, sid, (starts.repeat(s), his.repeat(s)),
            view=_maybe_cached_view(fcfg, f))
        out, n, hops, more = R.gather_fused(r, lane)
        out = out.reshape(s, k, max_items)
        n, hops, more = n.reshape(s, k), hops.reshape(s, k), more.reshape(s, k)
    else:
        out, n, hops, more = R.dispatch(
            s, lambda t: E.scan(cfg, t, starts, his, max_out=max_items),
            f.trees)
    # shard bands are key-disjoint and shard order is key order: the sorted
    # union's first max_items are the bands in split order, truncated where
    # the page fills (sentinel padding sorts last)
    union = torch.sort(out.transpose(0, 1).reshape(k, s * max_items),
                       dim=1).values[:, :max_items]
    total = n.sum(0, dtype=torch.int32)
    return (union, total.clamp(max=max_items), hops.sum(0, dtype=torch.int32),
            more.any(0) | (total > max_items))


# --------------------------------------------------------------------------
# batched updates
# --------------------------------------------------------------------------


def update_batch(fcfg: ForestConfig, f: Forest, kinds, keys, payloads=None):
    """Routed batch-order updates; per-shard maintenance under the tree
    config's ``maintenance`` policy, shard after shard.

    Returns (forest, results[K] bool, MaintenanceStats) — stats reduced
    over shards (``rounds`` the max, the critical path of shards that the
    JAX forest runs concurrently; work counters and ``pending`` summed).
    The arenas are updated in place: the returned Forest shares them with
    ``f`` and carries the next ``epoch``.

    Updates share the reads' key-domain boundary (`_route_keys`): a key
    outside the int32 domain is a no-op row with result False."""
    dev = f.splits.device
    kq = torch.as_tensor(keys, device=dev)
    in_domain = (kq >= layout.KEY_MIN) & (kq <= layout.KEY_MAX)
    kinds = torch.where(in_domain,
                        torch.as_tensor(kinds, device=dev).to(torch.int32),
                        OP_SEARCH)
    keys = _route_keys(kq, dev)
    k = keys.shape[0]
    if payloads is None:
        payloads = torch.zeros(k, dtype=torch.int32, device=dev)
    payloads = torch.as_tensor(payloads, device=dev).to(torch.int32)
    r = R.route(f.splits, keys)
    s = fcfg.num_shards
    dkinds = R.scatter_dense(r, s, kinds, OP_SEARCH)   # pads are no-ops
    dkeys = R.scatter_dense(r, s, keys, 0)
    dpays = R.scatter_dense(r, s, payloads, 0)
    # the trees are written in place: only results and stats come back
    dres, stats = R.dispatch(
        s, lambda t, kn, ks, ps: DT.update_batch_impl(fcfg.tree, t, kn, ks,
                                                      ps)[1:],
        f.trees, dkinds, dkeys, dpays)
    # per-shard cumulative update counters: non-search rows after the
    # domain mask (a clamped-out row never reaches a shard)
    upd = torch.zeros(s, dtype=torch.int32, device=dev).index_add_(
        0, r.sid.long(), (kinds != OP_SEARCH).to(torch.int32))
    return (f._replace(updates=f.updates + upd, epoch=f.epoch + 1),
            R.gather_batch(r, dres), MaintenanceStats.reduce(stats))


def flush(fcfg: ForestConfig, f: Forest, budget: int = 64):
    """Drain pending maintenance on every shard (restores I5 forest-wide
    after ``deferred`` / ``budgeted`` batches).  Returns (forest, stats);
    in place, like `update_batch`."""
    (stats,) = R.dispatch(fcfg.num_shards,
                          lambda t: DT.flush_impl(fcfg.tree, t, budget)[1:],
                          f.trees)
    return f._replace(epoch=f.epoch + 1), MaintenanceStats.reduce(stats)


# --------------------------------------------------------------------------
# per-shard load counters
# --------------------------------------------------------------------------


def record_reads(fcfg: ForestConfig, f: Forest, keys) -> Forest:
    """Fold one read batch into the cumulative per-shard ``reads``
    counters.  Reads themselves are pure, so counting them is an explicit
    state transition the caller opts into."""
    sid = R.shard_ids(f.splits, _route_keys(keys, f.splits.device))
    return f._replace(reads=f.reads + R.lane_counts(sid, fcfg.num_shards))


def shard_load(f: Forest) -> dict:
    """Host-side view of the cumulative per-shard op counters."""
    return {"reads": f.reads.cpu().tolist(),
            "updates": f.updates.cpu().tolist()}


# --------------------------------------------------------------------------
# host-side debug / verification
# --------------------------------------------------------------------------


def live_items(fcfg: ForestConfig, f: Forest):
    """All live (key, payload) pairs, key-sorted (shard order is key
    order), gathered from every rank."""
    sp = R.span(fcfg.num_shards)
    out = []
    for j in range(sp.local):
        out.extend(DT.live_items(fcfg.tree, shard_tree(f, j)))
    if sp.ranks == 1:
        return out
    parts = [None] * R.world()[1]
    dist.all_gather_object(parts, out)
    return [item for part in parts[:sp.ranks] for item in part]


def live_keys(fcfg: ForestConfig, f: Forest) -> np.ndarray:
    return np.asarray([k for k, _ in live_items(fcfg, f)], dtype=np.int64)


def alloc_failed(f: Forest) -> bool:
    """True if any shard's arena ever ran out (sticky, like the tree), on
    any rank."""
    return bool(R.gather_shards(f.reads.shape[0], f.trees.alloc_fail).any())
