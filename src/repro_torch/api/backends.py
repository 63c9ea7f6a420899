"""Built-in Index backends (port of ``repro.api.backends``): deltatree,
forest, sorted_array, and the paper's comparison structures pointer_bst and
static_veb.

``deltatree`` is the paper's structure, one arena on one device;
``forest`` the key-range-sharded DeltaForest with every shard on that
device.  The baselines (`core.baselines`) keep their state on the device
too.  Backends whose update only understands insert/delete rows
(``sorted_array``, ``pointer_bst``, ``static_veb``) neutralize search rows
with ``OpBatch.mask_searches`` (a delete of key 0, which is never stored).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.index import BackendSpec, Capability
from repro_torch.api.opbatch import OpBatch
from repro_torch.api.registry import register_backend
from repro_torch.core import baselines as BL
from repro_torch.core import deltatree as DT
from repro_torch.core import layout
from repro_torch.core import transfers as TR
from repro_torch.core.deltatree import TreeConfig
from repro_torch.distributed import forest as F
from repro_torch.distributed.forest import ForestConfig
from repro_torch.maintenance.policy import KINDS

_TREE_FIELDS = {f.name for f in dataclasses.fields(TreeConfig)}


def _as_cfg(cls, cfg, kw):
    if cfg is None:
        return cls(**kw)
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _dt_make(initial, payloads, cfg=None, device=None, **kw):
    cfg = _as_cfg(TreeConfig, cfg, kw)
    if initial is None:
        return cfg, DT.empty(cfg, device)
    return cfg, DT.bulk_build(cfg, np.asarray(initial), payloads, device)


def _dt_update(cfg, t, batch: OpBatch):
    batch = batch.to(t.value.device)
    return DT.update_batch(cfg, t, batch.kinds, batch.keys, batch.payloads)


def _unpack_scan(cfg, out, n, hops, more):
    """Packed engine-scan rows -> the BackendSpec scan contract: (keys,
    payloads, n, hops, more) with (K, max_items) int32 rows zero-padded
    past ``n`` (0 is outside the key domain, so the pad is unambiguous)."""
    span = torch.arange(out.shape[1], dtype=torch.int32, device=out.device)
    valid = span[None, :] < n[:, None]
    keys = torch.where(valid, cfg.key_of(out).to(torch.int32), 0)
    pays = torch.where(valid, cfg.payload_of(out).to(torch.int32), 0)
    return keys, pays, n, hops, more


def _dt_scan(cfg, t, starts, his, max_items):
    return _unpack_scan(cfg, *DT.scan_batch(cfg, t, starts, his, max_items))


def _dt_successor_k(cfg, t, keys, k):
    return _unpack_scan(cfg, *DT.successor_k_batch(cfg, t, keys, k))


def _dt_size(cfg, t) -> int:
    # I5 / I5': between steps every live item is a live leaf or a buffered
    # entry (never both — inserts dedup against the buffer), so nlive +
    # bcount over live ΔNodes is exact under every maintenance policy
    return int(torch.where(t.alive, t.nlive + t.bcount, 0).sum())


register_backend(BackendSpec(
    name="deltatree",
    make=_dt_make,
    capability=lambda cfg: Capability(
        map_mode=cfg.payload_bits > 0, successor=True, sharded=False,
        deferred_maintenance=True, range_scan=True, successor_k=True),
    search=DT.search_batch,
    lookup=DT.lookup_batch,
    update=_dt_update,
    successor=DT.successor_batch,
    scan=_dt_scan,
    successor_k=_dt_successor_k,
    live_items=DT.live_items,
    size=_dt_size,
    touch=TR.delta_touch_fn,
    alloc_failed=lambda cfg, t: bool(t.alloc_fail),
    flush=DT.flush,
    engines=("*",),   # reads dispatch on cfg.engine: any registered engine
    maintenance=KINDS,
))


# --------------------------------------------------------------------------
# forest — the key-range-sharded DeltaForest (repro_torch.distributed)
# --------------------------------------------------------------------------


def _forest_make(initial, payloads, cfg=None, splits=None, device=None,
                 **kw):
    # TreeConfig knobs (notably ``engine``) land on cfg.tree, the rest on
    # the ForestConfig itself
    tree_kw = {k: kw.pop(k) for k in list(kw) if k in _TREE_FIELDS}
    if cfg is None:
        tree = kw.pop("tree", None)
        tree = (dataclasses.replace(tree, **tree_kw) if tree is not None
                else TreeConfig(**tree_kw))
        cfg = ForestConfig(tree=tree, **kw)
    else:
        if tree_kw:
            cfg = dataclasses.replace(
                cfg, tree=dataclasses.replace(cfg.tree, **tree_kw))
        if kw:
            cfg = dataclasses.replace(cfg, **kw)
    if initial is None:
        return cfg, F.empty(cfg, splits, device)
    return cfg, F.bulk_build(cfg, np.asarray(initial), payloads, splits,
                             device)


def _forest_fused(cfg: ForestConfig) -> bool:
    """True when this config's forest reads run the fused cross-shard
    frontier (``cfg.fused`` on AND the engine has a ``forest_batch``
    entry point — see `repro_torch.core.engine`)."""
    from repro_torch.core import engine as E

    try:
        eng = E.get_engine(cfg.tree.engine)
    except KeyError:
        return False   # bad engine names fail later in make_index
    return bool(cfg.fused) and eng.forest_batch is not None


def _forest_update(cfg, f, batch: OpBatch):
    batch = batch.to(f.splits.device)
    return F.update_batch(cfg, f, batch.kinds, batch.keys, batch.payloads)


def _forest_scan(cfg, f, starts, his, max_items):
    return _unpack_scan(
        cfg.tree, *F.scan_batch(cfg, f, starts, his, max_items=max_items))


def _forest_successor_k(cfg, f, keys, k):
    return _unpack_scan(cfg.tree, *F.successor_k(cfg, f, keys, k))


def _forest_size(cfg, f) -> int:
    t = f.trees
    return int(torch.where(t.alive, t.nlive + t.bcount, 0).sum())


register_backend(BackendSpec(
    name="forest",
    make=_forest_make,
    capability=lambda cfg: Capability(
        map_mode=cfg.tree.payload_bits > 0, successor=True, sharded=True,
        deferred_maintenance=True, fused_forest=_forest_fused(cfg),
        range_scan=True, successor_k=True),
    search=F.search_batch,
    lookup=F.lookup_batch,
    update=_forest_update,
    successor=F.successor_jit,
    scan=_forest_scan,
    successor_k=_forest_successor_k,
    live_items=F.live_items,
    size=_forest_size,
    alloc_failed=lambda cfg, f: F.alloc_failed(f),
    flush=F.flush,
    engines=("*",),   # per-shard reads dispatch on cfg.tree.engine
    maintenance=KINDS,   # per-shard scheduler on cfg.tree.maintenance
))


# --------------------------------------------------------------------------
# sorted_array — binary search + sort-merge rebuild (core.baselines)
# --------------------------------------------------------------------------


def _initial(initial) -> np.ndarray:
    return (np.asarray(initial) if initial is not None
            else np.zeros(0, np.int32))


@dataclasses.dataclass(frozen=True)
class SortedArrayConfig:
    cap: int | None = None   # None: build auto-sizes to 2x the initial keys


def _sa_make(initial, payloads, cfg=None, device=None, **kw):
    cfg = _as_cfg(SortedArrayConfig, cfg, kw)
    return cfg, BL.SortedArray.build(_initial(initial), cap=cfg.cap,
                                     device=device)


def _sa_search(cfg, state, keys):
    keys = torch.as_tensor(keys, dtype=torch.int32, device=state.vals.device)
    return BL.SortedArray.search(state, keys), torch.zeros_like(keys)


def _masked_update(update, state, batch: OpBatch, device):
    """``update`` over the batch with OP_SEARCH rows masked out; returns
    (state, results, None): no maintenance scheduler."""
    kinds, keys, is_update = batch.to(device).mask_searches()
    state, res = update(state, kinds, keys)
    return state, res & is_update, None


def _sa_update(cfg, state, batch: OpBatch):
    return _masked_update(BL.SortedArray.update, state, batch,
                          state.vals.device)


def _sa_successor(cfg, state, keys):
    keys = torch.as_tensor(keys, dtype=torch.int32, device=state.vals.device)
    i = torch.searchsorted(state.vals, keys, right=True).to(torch.int32)
    found = i < state.n
    safe = i.clamp(0, state.vals.shape[0] - 1).long()
    return found, torch.where(found, state.vals[safe], 0)


def _sa_live_items(cfg, state):
    n = int(state.n)
    return [(int(v), 0) for v in state.vals[:n].tolist()]


def _sa_scan(cfg, state, starts, his, max_items):
    """The dense-scan baseline: the page is one searchsorted window per
    lane over the flat sorted array, no tree walk at all."""
    dev = state.vals.device
    starts = torch.as_tensor(starts, dtype=torch.int32, device=dev)
    his = torch.as_tensor(his, dtype=torch.int32, device=dev)
    i0 = torch.searchsorted(state.vals, starts, right=True).to(torch.int32)
    ic = torch.searchsorted(state.vals, his, right=True).to(torch.int32)
    total = torch.clamp(torch.minimum(ic, state.n)
                        - torch.minimum(i0, state.n), min=0)
    span = torch.arange(max_items, dtype=torch.int32, device=dev)
    idx = (i0[:, None] + span[None, :]).clamp(0, state.vals.shape[0] - 1)
    valid = span[None, :] < total[:, None]
    keys = torch.where(valid, state.vals[idx.long()], 0)
    return (keys, torch.zeros_like(keys), torch.clamp(total, max=max_items),
            torch.zeros_like(starts), total > max_items)


def _sa_successor_k(cfg, state, keys, k):
    keys = torch.as_tensor(keys, dtype=torch.int32, device=state.vals.device)
    return _sa_scan(cfg, state, keys, torch.full_like(keys, layout.KEY_MAX),
                    k)


register_backend(BackendSpec(
    name="sorted_array",
    make=_sa_make,
    capability=lambda cfg: Capability(successor=True, range_scan=True,
                                      successor_k=True),
    search=_sa_search,
    update=_sa_update,
    successor=_sa_successor,
    scan=_sa_scan,
    successor_k=_sa_successor_k,
    live_items=_sa_live_items,
    size=lambda cfg, state: int(state.n),
    touch=lambda cfg, state: BL.SortedArray.touch_fn(state),
))


# --------------------------------------------------------------------------
# pointer_bst — heap-allocated BST analog (no locality; core.baselines)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PointerBSTConfig:
    cap: int | None = None   # None: build auto-sizes to 2x the initial keys
    seed: int = 0


def _bst_make(initial, payloads, cfg=None, device=None, **kw):
    cfg = _as_cfg(PointerBSTConfig, cfg, kw)
    return cfg, BL.PointerBST.build(_initial(initial), cap=cfg.cap,
                                    seed=cfg.seed, device=device)


def _bst_search(cfg, state, keys):
    keys = torch.as_tensor(keys, dtype=torch.int32, device=state.val.device)
    return BL.PointerBST.search(state, keys), torch.zeros_like(keys)


def _bst_update(cfg, state, batch: OpBatch):
    return _masked_update(BL.PointerBST.update, state, batch,
                          state.val.device)


def _bst_live_items(cfg, state):
    n = int(state.n)
    vals = state.val[:n]
    return [(int(v), 0) for v in torch.sort(vals[~state.mark[:n]])
            .values.tolist()]


register_backend(BackendSpec(
    name="pointer_bst",
    make=_bst_make,
    capability=lambda cfg: Capability(),
    search=_bst_search,
    update=_bst_update,
    live_items=_bst_live_items,
    size=lambda cfg, state: int(state.n) - int(
        state.mark[: int(state.n)].sum()),
    touch=lambda cfg, state: BL.PointerBST.touch_fn(state),
))


# --------------------------------------------------------------------------
# static_veb — VTMtree analog: search-optimal, whole-layout rebuild updates
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StaticVEBConfig:
    height: int | None = None   # None: minimal height for the build


def _sv_make(initial, payloads, cfg=None, device=None, **kw):
    cfg = _as_cfg(StaticVEBConfig, cfg, kw)
    return cfg, BL.StaticVEB.build(_initial(initial), height=cfg.height,
                                   device=device)


def _sv_search(cfg, state, keys):
    keys = torch.as_tensor(keys, dtype=torch.int32,
                           device=state.store.device)
    return BL.StaticVEB.search(state, keys), torch.zeros_like(keys)


def _sv_update(cfg, state, batch: OpBatch):
    dev = state.store.device
    kinds = batch.kinds.cpu().numpy()
    keys = batch.keys.cpu().numpy()
    mask = kinds != DT.OP_SEARCH
    res = np.zeros(len(keys), bool)
    if mask.any():
        state, sub = BL.StaticVEB.update(state, kinds[mask], keys[mask])
        if cfg.height is not None and state.height != cfg.height:
            # StaticVEB.update rebuilds at minimal height; re-pin the
            # configured layout (build still grows h if the set outgrew it)
            state = BL.StaticVEB.build(BL.StaticVEB.to_sorted(state),
                                       height=cfg.height, device=dev)
        res[mask] = sub.cpu().numpy()
    return state, torch.from_numpy(res).to(dev), None


def _sv_live_items(cfg, state):
    return [(int(v), 0) for v in BL.StaticVEB.to_sorted(state)]


def _sv_scan(cfg, state, starts, his, max_items):
    """Host-side scan over the recovered sorted key set (the VTMtree analog
    rebuilds wholesale anyway, so its ordered reads are a host replay of
    the layout's in-order traversal)."""
    dev = state.store.device
    vals = np.asarray(BL.StaticVEB.to_sorted(state), np.int32)
    starts = np.asarray(torch.as_tensor(starts).cpu(), np.int32)
    his = np.asarray(torch.as_tensor(his).cpu(), np.int32)
    i0 = np.searchsorted(vals, starts, side="right")
    ic = np.searchsorted(vals, his, side="right")
    total = np.maximum(ic - i0, 0)
    keys = np.zeros((starts.shape[0], max_items), np.int32)
    for j in range(starts.shape[0]):
        got = vals[i0[j]: ic[j]][:max_items]
        keys[j, : got.size] = got
    keys = torch.from_numpy(keys).to(dev)
    return (keys, torch.zeros_like(keys),
            torch.from_numpy(np.minimum(total, max_items).astype(np.int32))
            .to(dev),
            torch.zeros(starts.shape[0], dtype=torch.int32, device=dev),
            torch.from_numpy(total > max_items).to(dev))


def _sv_successor_k(cfg, state, keys, k):
    keys = np.asarray(torch.as_tensor(keys).cpu(), np.int32)
    his = np.full(keys.shape, layout.KEY_MAX, np.int32)
    return _sv_scan(cfg, state, keys, his, k)


register_backend(BackendSpec(
    name="static_veb",
    make=_sv_make,
    capability=lambda cfg: Capability(range_scan=True, successor_k=True),
    search=_sv_search,
    update=_sv_update,
    scan=_sv_scan,
    successor_k=_sv_successor_k,
    live_items=_sv_live_items,
    size=lambda cfg, state: int(BL.StaticVEB.to_sorted(state).size),
    touch=lambda cfg, state: BL.StaticVEB.touch_fn(state),
))
