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
the same per-query ``hops`` (ΔNodes visited), bit for bit.

Not yet ported: ``engine="auto"`` (its table was measured on a TPU; the
port gets one from H100 rows), scans, the fused forest entry point and
read statistics.
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
class SearchEngine:
    """One registered read path: functions over (cfg, tree, keys).

    lookup:    (cfg, t, keys[K]) -> (found[K], payload[K], hops[K]) —
               map-mode read; set mode returns payload 0/-1.  ``search``
               is this minus the payload column.
    successor: (cfg, t, keys[K]) -> (found[K], succ[K])
    """

    name: str
    lookup: Callable[..., Any]
    successor: Callable[..., Any]


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


def lookup(cfg, t, keys):
    """Engine-dispatched map-mode read: (found[K], payload[K], hops[K])."""
    with TR.annotate(f"engine.{cfg.engine}.lookup"):
        return get_engine(cfg.engine).lookup(cfg, t, _keys(t, keys))


def search(cfg, t, keys):
    """Engine-dispatched membership read: (found[K], hops[K])."""
    found, _, hops = lookup(cfg, t, keys)
    return found, hops


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


register_engine(SearchEngine(
    name="scalar", lookup=_scalar_lookup, successor=_scalar_successor))


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


register_engine(SearchEngine(
    name="lockstep", lookup=_lockstep_lookup, successor=_lockstep_successor))
