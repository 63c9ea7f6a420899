"""SearchEngine layer — pluggable read path for the ΔTree (port of
``repro.core.engine``; DESIGN.md §6).

Every wait-free read (search / lookup / successor) on a ``DeltaTree`` goes
through one registered engine, picked by ``cfg.engine``:

- ``"scalar"``  — the reference walk: one host-driven `deltatree._descend`
  per query (the JAX engine's vmap of per-query while-loops, as a Python
  loop).  Correct everywhere; slow on a card, where each ΔNode visited is
  a host sync.
- ``"lockstep"`` — the walk kernels (`kernels.ops.delta_walk`): the whole
  batch descends together, every ΔNode visit a row of the arena read on
  the device; the fused walk runs all rounds in one CUDA launch.

Both engines resolve through the same `deltatree.searchnode` and report
the same per-query ``hops`` (ΔNodes visited), bit for bit.  Both serve
ordered range scans (`scan`, `successor_k`): the scalar engine with one
host-driven `deltatree.scan_one` per lane, the lockstep engine with one
`kernels.ops.delta_scan` launch for the whole batch; under non-eager
maintenance one shared merge adds the pending overflow-buffer items.

The lockstep engine also declares a ``forest_batch`` entry point
(``ForestBatch``): fused cross-shard reads over a base-offset view of the
forest's stacked shard arenas — one walk (or scan) launch with per-lane
roots for the whole routed batch instead of one per shard.  The forest
(`repro_torch.distributed.forest`) picks it through ``TreeConfig.engine``
(DESIGN.md §8); the scalar engine declares none and keeps the dense
per-shard dispatch as the reference.

Reads return a trailing ``ReadStats`` (`repro_torch.obs.stats`) when
``cfg.collect_stats`` is set, derived here in the dispatch from the
engines' own columns.  Not yet ported: ``engine="auto"`` (its table was
measured on a TPU; the port gets one from H100 rows).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import deltatree as DT
from repro_torch.core import layout
from repro_torch.core.layout import EMPTY
from repro_torch.obs import trace as TR


@dataclasses.dataclass(frozen=True)
class ForestBatch:
    """An engine's fused cross-shard forest entry point (DESIGN.md §8).

    The hooks run over the stacked (S, ...) arena ``trees`` fused into one
    base-offset arena view, every lane seeded at its owner shard's root
    (``lid`` = per-lane shard index).  One kernel launch serves every
    shard — no dense (S, K) scatter, no loop over shards.

    lookup:    (cfg, trees, lid[K], keys[K], *, view=None)
               -> (found, payload, hops)
    successor: (cfg, trees, lid[K], keys[K], *, view=None)
               -> (found[K], succ[K], has_min[S], mins[S]) — the
               per-shard minimum probes (successor of KEY_MIN-1, one per
               shard) ride the same chase as S extra lanes; the forest's
               cross-shard suffix-min combine consumes them.
    make_view: (cfg, trees) -> view — the fused view the hooks otherwise
               build inline; a caller holding an unchanged arena across
               reads builds it once and passes it back through ``view=``.
               Part of it is a copy of the arena (the shifted child
               links), so a view is stale once the arena's links change
               (the forest's view cache says how it tells).
    scan:      (cfg, trees, lid[K], starts[K], his[K], max_out, *,
               view=None) -> (out[K, max_out], n, hops, more) — one
               emit-cursor lane per (lane, shard) pair, each scanning its
               own shard, the I5' buffered merge against that shard's
               buffers included.

    Results equal the dense per-shard dispatch bit for bit
    (found/payload/succ/scan rows and per-lane hops).
    """

    lookup: Callable[..., Any]
    successor: Callable[..., Any]
    make_view: Callable[..., Any]
    scan: Callable[..., Any]


@dataclasses.dataclass(frozen=True)
class SearchEngine:
    """One registered read path: functions over (cfg, tree, keys).

    lookup:    (cfg, t, keys[K]) -> (found[K], payload[K], hops[K]) —
               map-mode read; set mode returns payload 0/-1.  ``search``
               is this minus the payload column.
    successor: (cfg, t, keys[K]) -> (found[K], succ[K])
    scan_batch: optional ordered bulk read — (cfg, t, starts[K], his[K],
               max_out) -> (out[K, max_out] packed, n[K],
               hops[K], more[K]) — up to ``max_out`` live *leaf* items per
               lane with start < key <= hi, key ascending; tree side only
               (the `scan` dispatch merges I5' buffered items).  None
               means the engine cannot serve range_scan / successor_k.
    forest_batch: optional fused cross-shard read entry point
               (``ForestBatch``); None means the forest reads through the
               dense per-shard dispatch under this engine.
    """

    name: str
    lookup: Callable[..., Any]
    successor: Callable[..., Any]
    scan_batch: Callable[..., Any] | None = None
    forest_batch: ForestBatch | None = None


_ENGINES: dict[str, SearchEngine] = {}


def register_engine(engine: SearchEngine, *, overwrite: bool = False
                    ) -> SearchEngine:
    """Install ``engine`` under ``engine.name``; re-registration opts in."""
    if engine.name in _ENGINES and not overwrite:
        raise ValueError(f"engine {engine.name!r} already registered")
    _ENGINES[engine.name] = engine
    return engine


def get_engine(name: str) -> SearchEngine:
    try:
        return _ENGINES[name]
    except KeyError:
        raise KeyError(
            f"unknown engine {name!r}; registered: {available_engines()}"
        ) from None


def available_engines() -> list[str]:
    return sorted(_ENGINES)


# --------------------------------------------------------------------------
# dispatch (the entry points deltatree and the Index backend delegate to)
# --------------------------------------------------------------------------


def _keys(t, keys) -> torch.Tensor:
    return torch.as_tensor(keys, dtype=torch.int32, device=t.value.device)


def collecting(cfg) -> bool:
    """The observability gate (``TreeConfig.collect_stats``).  Configs
    without the field (the baselines) never collect."""
    return bool(getattr(cfg, "collect_stats", False))


def collecting_transfers(cfg) -> bool:
    """The sub-gate of the measured ``TransferStats`` (the descent replay):
    on only when ``collect_stats`` already is."""
    return collecting(cfg) and bool(getattr(cfg, "collect_transfers", False))


def _read_stats(cfg, t, keys, found, hops):
    """The trailing ``ReadStats`` of a stats-collecting read, derived from
    the dispatch's own (found, hops) columns, which both engines produce
    bit for bit, so the stats of the two engines agree by construction.
    The transfer leg replays the descent from (arena, root, keys) alone,
    engine-independent for the same reason."""
    from repro_torch.obs.stats import ReadStats, SearchStats

    pad = keys == layout.ROUTE_LEFT
    bhit = found & DT.buffered_member(cfg, t, keys)
    transfers = None
    if collecting_transfers(cfg):
        from repro_torch.obs import transfers as OTR

        transfers = OTR.measure(cfg, t, keys)
    return ReadStats(search=SearchStats.of(hops, pad, bhit),
                     transfers=transfers)


def lookup_cols(cfg, t, keys):
    """The bare engine hook: always (found[K], payload[K], hops[K]), never
    stats.  The forest's dense dispatch reads through this, so its stats
    are derived once, in the forest's own dispatch layer."""
    with TR.annotate(f"engine.{cfg.engine}.lookup"):
        return get_engine(cfg.engine).lookup(cfg, t, _keys(t, keys))


def lookup(cfg, t, keys):
    """Engine-dispatched map-mode read: (found[K], payload[K], hops[K]),
    plus a trailing ``ReadStats`` when ``cfg.collect_stats``."""
    keys = _keys(t, keys)
    out = lookup_cols(cfg, t, keys)
    if not collecting(cfg):
        return out
    found, payload, hops = out
    return found, payload, hops, _read_stats(cfg, t, keys, found, hops)


def search(cfg, t, keys):
    """Engine-dispatched membership read: (found[K], hops[K]), plus a
    trailing ``ReadStats`` when ``cfg.collect_stats``."""
    found, _, hops, *stats = lookup(cfg, t, keys)
    return (found, hops, *stats)


def successor(cfg, t, keys):
    """Engine-dispatched ordered read: (found[K], succ[K]).

    On trees that carry pending buffer items (I5', non-eager maintenance)
    the dispatch folds the buffered successor floor into the tree-side
    result; eager trees skip the fold (buffers are empty between steps).
    """
    with TR.annotate(f"engine.{cfg.engine}.successor"):
        found, succ = get_engine(cfg.engine).successor(cfg, t, _keys(t, keys))
    if cfg.maintenance == "eager":
        return found, succ
    return _fold_floor(cfg, DT.buffered_floor(cfg, t, keys), found, succ)


def _fold_floor(cfg, bf, found, succ):
    """Fold a buffered-floor column into a tree-side successor result:
    the live set is (tree-live ∪ buffered) and the sides are disjoint, so
    the min of the two successors is the successor over the union."""
    bfound = bf < cfg.route_left
    bkey = cfg.key_of(bf).to(succ.dtype)
    better = bfound & (~found | (bkey < succ))
    return found | bfound, torch.where(better, bkey, succ)


def scan(cfg, t, starts, his, *, max_out: int):
    """Engine-dispatched ordered bulk read: per lane, up to ``max_out``
    live items with ``start < key <= hi`` in key order.

    Returns (out (K, max_out) packed ascending with ``cfg.route_left``
    padding, n (K,), hops (K,), more (K,) bool); ``more`` marks lanes that
    filled their row with live items remaining — the continuation cursor
    is ``key_of(out[lane, n-1])``.

    Under a non-eager maintenance policy the engines' tree-side run misses
    pending overflow-buffer items (invariant I5'); the dispatch merges them
    here, one shared merge above both engines (`_merge_buffered_run`), so
    scalar/lockstep parity of the merged run is structural, like
    `successor`'s `_fold_floor`.  Eager trees skip the merge.
    """
    eng = get_engine(cfg.engine)
    if eng.scan_batch is None:
        raise NotImplementedError(
            f"engine {cfg.engine!r} declares no scan_batch hook")
    starts, his = _keys(t, starts), _keys(t, his)
    with TR.annotate(f"engine.{cfg.engine}.scan"):
        out, n, hops, more = eng.scan_batch(cfg, t, starts, his, max_out)
    if cfg.maintenance == "eager":
        return out, n, hops, more
    out, n, more = _merge_buffered_run(cfg, t, starts, his, out, n, more,
                                       max_out)
    return out, n, hops, more


def successor_k(cfg, t, keys, k: int):
    """Engine-dispatched bulk successors: the ``k`` smallest live keys
    strictly greater than each query key — `scan` with an unbounded upper
    band (same return contract; ``more`` = more than ``k`` successors)."""
    keys = _keys(t, keys)
    his = torch.full_like(keys, layout.KEY_MAX)
    return scan(cfg, t, keys, his, max_out=k)


def _merge_buffered_run(cfg, t, starts, his, out, n, more, max_out: int):
    """Merge each lane's I5' buffered items into its emitted tree run.

    One sort of the flattened buffer arena (``route_left`` padding), then
    per lane the window of buffered values in (start, cap], where ``cap``
    is the last tree-emitted key when the tree side overflowed (items past
    the truncation point belong to the continuation — unseen *tree* items
    there could precede them) and ``hi`` otherwise.  Leaves and buffers are
    key-disjoint (inserts dedup against both), so the union of the two
    sorted runs is strictly sorted and a concat + row sort merges them.
    Skipped, one host check, when every buffer is empty.
    """
    if not bool((t.bcount > 0).any()):
        return out, n, more
    big = cfg.route_left
    flat = torch.where(t.buf != EMPTY, t.buf, big).reshape(-1)
    s = torch.sort(flat).values
    nb = s.shape[0]
    idx0 = torch.searchsorted(s, cfg.qpack(starts).to(s.dtype),
                              right=True).to(torch.int32)
    last = out.gather(1, (n - 1).clamp(0, max_out - 1).long()[:, None])[:, 0]
    cap = torch.where(more, last | cfg.pmask, cfg.qpack(his).to(s.dtype))
    idxc = torch.searchsorted(s, cap, right=True).to(torch.int32)
    bic = idxc - idx0                     # buffered count in (start, cap]
    span = torch.arange(max_out, dtype=torch.int32, device=s.device)
    win = (idx0[:, None] + span[None, :]).clamp(0, nb - 1).long()
    cands = torch.where(span[None, :] < bic[:, None], s[win],
                        torch.full_like(win, big, dtype=s.dtype))
    union = torch.sort(torch.cat([out, cands], dim=1), dim=1).values
    return (union[:, :max_out], torch.clamp(n + bic, max=max_out),
            more | (n + bic > max_out))


def forest_batch(cfg) -> ForestBatch | None:
    """``cfg.engine``'s fused forest entry point (None = dense dispatch)."""
    return get_engine(cfg.engine).forest_batch


# --------------------------------------------------------------------------
# "scalar" — the reference engine (one host-driven descent per query)
# --------------------------------------------------------------------------


def _scalar_lookup(cfg, t, keys: torch.Tensor):
    dev = t.value.device
    root = int(t.root)
    walks = [DT._descend(cfg, t, cfg.qpack(k), root, 1) for k in keys.tolist()]
    dn, b, hops = (torch.tensor([w[i] for w in walks], dtype=torch.int32,
                                device=dev).reshape(-1) for i in range(3))
    leaf_val = t.value[dn.long(), DT._pos(cfg, dev)[b.long()]]
    found, payload = DT.searchnode(cfg, t, keys, leaf_val, b, dn)
    # the reserved ROUTE_LEFT key (router pad lanes, clamped above-domain
    # probes) is born resolved under the lockstep walk sentinel contract:
    # mirror it here — deterministic miss, payload -1, hops 0
    pad = keys == layout.ROUTE_LEFT
    return (found & ~pad, torch.where(pad, -1, payload),
            torch.where(pad, 0, hops))


def _scalar_successor(cfg, t, keys: torch.Tensor):
    res = [DT.successor_one(cfg, t, k) for k in keys.tolist()]
    dev = t.value.device
    return (torch.tensor([r[0] for r in res], dtype=torch.bool, device=dev),
            torch.tensor([r[1] for r in res], dtype=torch.int32, device=dev))


def _scalar_scan(cfg, t, starts: torch.Tensor, his: torch.Tensor,
                 max_out: int):
    """One host-driven `deltatree.scan_one` per lane."""
    k, dev = starts.shape[0], t.value.device
    out = torch.empty((k, max_out), dtype=cfg.vdtype, device=dev)
    n = torch.empty(k, dtype=torch.int32, device=dev)
    hops = torch.empty(k, dtype=torch.int32, device=dev)
    more = torch.empty(k, dtype=torch.bool, device=dev)
    for i, (s, h) in enumerate(zip(starts.tolist(), his.tolist())):
        out[i], n[i], hops[i], more[i] = DT.scan_one(cfg, t, s, h, max_out)
    # reserved ROUTE_LEFT starts are born done under the lockstep pad-lane
    # sentinel contract: mirror it (empty run, hops 0)
    pad = starts == layout.ROUTE_LEFT
    return (torch.where(pad[:, None], torch.full_like(out, cfg.route_left),
                        out),
            torch.where(pad, 0, n), torch.where(pad, 0, hops), more & ~pad)


register_engine(SearchEngine(
    name="scalar", lookup=_scalar_lookup, successor=_scalar_successor,
    scan_batch=_scalar_scan))


# --------------------------------------------------------------------------
# "lockstep" — the walk kernels over the whole batch
# --------------------------------------------------------------------------


def _walk_queries(cfg, keys: torch.Tensor) -> torch.Tensor:
    """``cfg.qpack`` for the walk kernel, with the reserved ROUTE_LEFT key
    mapped to the packed walk sentinel (``walk_big``) so router pad lanes
    are born resolved in map mode too (in set mode ``qpack(ROUTE_LEFT)``
    *is* the sentinel already)."""
    from repro_torch.kernels.veb_search import walk_big

    q = cfg.qpack(keys)
    return torch.where(keys == layout.ROUTE_LEFT,
                       torch.full_like(q, walk_big(cfg.vdtype)), q)


def _lockstep_walk(cfg, t, qpacked: torch.Tensor, root=None):
    """The kernel walk: ``root`` defaults to the tree's root; a (K,)
    tensor seeds each query at its own root.  ``cfg.walk_fused`` picks the
    fused or the per-round walk, ``cfg.walk_round_cap`` the round bound."""
    from repro_torch.kernels import ops as OPS

    return OPS.delta_walk(t.value, t.child, t.root if root is None else root,
                          qpacked, height=cfg.height,
                          max_rounds=cfg.walk_round_cap, fused=cfg.walk_fused)


def _lockstep_lookup(cfg, t, keys: torch.Tensor):
    lv, lb, dn, hops, _ = _lockstep_walk(cfg, t, _walk_queries(cfg, keys))
    # SEARCHNODE resolution shared verbatim with the scalar engine
    found, payload = DT.searchnode(cfg, t, keys, lv, lb, dn)
    return found, payload, hops


def _successor_chase(cfg, t, keys: torch.Tensor, root=None,
                     max_chase: int = 8):
    """Lockstep successor core: the walk kernel folds the min left-turn
    router per round; a final leaf check and a bounded liveness chase
    mirror `deltatree.successor_one` lane for lane."""
    k = keys.shape[0]
    dev = t.value.device
    pos = DT._pos(cfg, dev)
    big = cfg.route_left

    def one_pass(qk):
        lv, lb, dn, _, cand = _lockstep_walk(cfg, t, _walk_queries(cfg, qk),
                                             root)
        leaf_live = (lv != EMPTY) & ~t.mark[dn.long(), pos[lb.long()]]
        leaf_gt = leaf_live & (cfg.key_of(lv) > qk)
        return torch.where(leaf_gt & (lv < cand), lv, cand)

    def live_of(qk):
        lv, lb, dn, _, _ = _lockstep_walk(cfg, t, _walk_queries(cfg, qk),
                                          root)
        return DT.searchnode(cfg, t, qk, lv, lb, dn)[0]

    qk = keys
    ck = torch.zeros(k, dtype=torch.int32, device=dev)
    found = torch.zeros(k, dtype=torch.bool, device=dev)
    active = torch.ones(k, dtype=torch.bool, device=dev)
    it = 0
    while it < max_chase and bool(active.any()):
        cand = one_pass(qk)
        cknew = cfg.key_of(cand)
        exists = cand < big
        # candidate routers may be tombstones: verify liveness in lockstep
        done_now = ~exists | live_of(cknew)
        qk = torch.where(active & ~done_now, cknew, qk)
        ck = torch.where(active, cknew, ck)
        found = torch.where(active, done_now & exists, found)
        active = active & ~done_now
        it += 1
    return found, torch.where(found, ck, 0)


def _lockstep_successor(cfg, t, keys: torch.Tensor, max_chase: int = 8):
    return _successor_chase(cfg, t, keys, max_chase=max_chase)


def _lockstep_scan(cfg, t, starts: torch.Tensor, his: torch.Tensor,
                   max_out: int, root=None):
    """The emit-cursor scan frontier: one `delta_scan` call for the whole
    batch — every FIND / VERIFY pass of every lane inside one
    `veb_scan_fused` launch.  ``root`` as in `_lockstep_walk`: per-lane
    seeds drive the fused multi-shard view, each lane in its own arena."""
    from repro_torch.kernels import ops as OPS

    return OPS.delta_scan(t.value, t.mark, t.child,
                          t.root if root is None else root,
                          _walk_queries(cfg, starts), cfg.qpack(his),
                          height=cfg.height, max_out=max_out,
                          pmask=int(cfg.pmask))


# ---- fused cross-shard frontier (the forest_batch entry point) ----


def _fused_trees_view(cfg, trees):
    """Stacked (S, M, ...) shard arenas -> one base-offset arena view.

    value/child/root fuse through `kernels.veb_search.fuse_arenas` (the
    shard base is applied to child links once, here); the SEARCHNODE-side
    arrays (mark, buf, per-ΔNode counters) are reshapes of the stacked
    tensors, so `DT.searchnode` indexes fused ΔNode ids directly, and
    ``parent`` is shifted like ``child``.  Shard-scoped fields (root,
    free_top, alloc_fail) keep shard 0's value and must not be read
    through the view: walks always pass per-lane roots.  ``child`` and
    ``parent`` are copies; everything else shows later in-place writes.
    Returns (view, fused_roots (S,))."""
    from repro_torch.kernels.veb_search import fuse_arenas

    # a per-ΔNode field kept at its stacked (S, M, ...) shape would be
    # indexed wrongly by fused ids: new fields must be taught to this view
    assert set(DT.DeltaTree._fields) == {
        "value", "mark", "child", "buf", "nlive", "bcount", "nchild",
        "parent", "pslot", "alive", "free_stack", "free_top", "root",
        "ins_flag", "del_flag", "alloc_fail",
    }, "new DeltaTree field: teach _fused_trees_view how it fuses"
    s, m = trees.value.shape[0], trees.value.shape[1]
    value, child, roots = fuse_arenas(trees.value, trees.child, trees.root)
    base = torch.arange(s, dtype=torch.int32, device=value.device) * m

    def flat(x):
        return x.reshape((s * m,) + x.shape[2:])

    view = trees._replace(
        value=value, child=child,
        mark=flat(trees.mark), buf=flat(trees.buf),
        nlive=flat(trees.nlive), bcount=flat(trees.bcount),
        nchild=flat(trees.nchild),
        parent=flat(torch.where(trees.parent >= 0,
                                trees.parent + base[:, None], trees.parent)),
        pslot=flat(trees.pslot), alive=flat(trees.alive),
        ins_flag=flat(trees.ins_flag), del_flag=flat(trees.del_flag),
        free_stack=flat(trees.free_stack), free_top=trees.free_top[0],
        root=trees.root[0], alloc_fail=trees.alloc_fail[0],
    )
    return view, roots


def _fused_lockstep_lookup(cfg, trees, lid, keys: torch.Tensor, *,
                           view=None):
    view, roots = _fused_trees_view(cfg, trees) if view is None else view
    lv, lb, dn, hops, _ = _lockstep_walk(cfg, view, _walk_queries(cfg, keys),
                                         roots[lid.long()])
    found, payload = DT.searchnode(cfg, view, keys, lv, lb, dn)
    return found, payload, hops


def _fused_fold_buffered(cfg, trees, lid, keys, found, succ):
    """The I5' buffered-floor fold of `successor`, per lane restricted to
    its owner shard: a later shard's pending item must reach a query
    through the cross-shard fallback (the shard-minimum probes), as on the
    dense dispatch, or the suffix-min combine would count it twice.  The
    same per-shard `buffered_floor` calls as the dense dispatch, one
    column kept per lane, so the fold is bit-identical by construction.
    Eager trees skip it."""
    if cfg.maintenance == "eager":
        return found, succ
    floors = torch.stack([DT.buffered_floor(cfg, DT.shard_of(trees, s), keys)
                          for s in range(trees.value.shape[0])])
    bf = floors[lid.long(), torch.arange(keys.shape[0], device=keys.device)]
    return _fold_floor(cfg, bf, found, succ)


def _fused_lockstep_successor(cfg, trees, lid, keys: torch.Tensor,
                              max_chase: int = 8, *, view=None):
    """Fused successor: K query lanes plus one shard-minimum probe lane
    per shard (successor of KEY_MIN-1 seeded at that shard's root) share
    one chase.  Returns (found[K], succ[K], has_min[S], mins[S])."""
    k = keys.shape[0]
    s = trees.value.shape[0]
    dev = keys.device
    view, roots = _fused_trees_view(cfg, trees) if view is None else view
    qk = torch.cat([keys, torch.full((s,), layout.KEY_MIN - 1,
                                     dtype=torch.int32, device=dev)])
    lid_all = torch.cat([lid.to(torch.int32),
                         torch.arange(s, dtype=torch.int32, device=dev)])
    found, succ = _successor_chase(cfg, view, qk, roots[lid_all.long()],
                                   max_chase=max_chase)
    found, succ = _fused_fold_buffered(cfg, trees, lid_all, qk, found, succ)
    return found[:k], succ[:k], found[k:], succ[k:]


def _fused_lockstep_scan(cfg, trees, lid, starts: torch.Tensor,
                         his: torch.Tensor, max_out: int, *, view=None):
    """Fused cross-shard scan: lane ``j`` is seeded at shard ``lid[j]``'s
    fused root, so its run is exactly that shard's band of the range, and
    one `delta_scan` launch serves every (lane, shard) pair the forest
    tiles out.  Under non-eager maintenance each lane merges the I5'
    buffered items of its *own* shard (shards partition the key space, so
    a pending item only belongs in its owner shard's band), through the
    same `_merge_buffered_run` the dense dispatch runs per shard."""
    view, roots = _fused_trees_view(cfg, trees) if view is None else view
    out, n, hops, more = _lockstep_scan(cfg, view, starts, his, max_out,
                                        root=roots[lid.long()])
    if cfg.maintenance == "eager":
        return out, n, hops, more
    for s in range(trees.value.shape[0]):
        sel = lid == s
        if not bool(sel.any()):
            continue
        out[sel], n[sel], more[sel] = _merge_buffered_run(
            cfg, DT.shard_of(trees, s), starts[sel], his[sel], out[sel],
            n[sel], more[sel], max_out)
    return out, n, hops, more


register_engine(SearchEngine(
    name="lockstep", lookup=_lockstep_lookup, successor=_lockstep_successor,
    scan_batch=_lockstep_scan,
    forest_batch=ForestBatch(
        lookup=_fused_lockstep_lookup,
        successor=_fused_lockstep_successor,
        make_view=_fused_trees_view,
        scan=_fused_lockstep_scan,
    )))
