"""Built-in Index backends (port of ``repro.api.backends``).

``deltatree`` — the paper's structure, one arena on one device — and
``forest``, the key-range-sharded DeltaForest with every shard on that
device.  The sorted-array and the paper's comparison structures are later
slices of the port (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.index import BackendSpec, Capability
from repro_torch.api.opbatch import OpBatch
from repro_torch.api.registry import register_backend
from repro_torch.core import deltatree as DT
from repro_torch.core.deltatree import TreeConfig
from repro_torch.distributed import forest as F
from repro_torch.distributed.forest import ForestConfig
from repro_torch.maintenance.policy import KINDS

_TREE_FIELDS = {f.name for f in dataclasses.fields(TreeConfig)}


def _no_stats(cfg: TreeConfig) -> None:
    if cfg.collect_stats or cfg.collect_transfers:
        raise NotImplementedError(
            "collect_stats is not ported to repro_torch yet (see ROADMAP.md)")


def _dt_make(initial, payloads, cfg=None, device=None, **kw):
    if cfg is None:
        cfg = TreeConfig(**kw)
    elif kw:
        cfg = dataclasses.replace(cfg, **kw)
    _no_stats(cfg)
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
    _no_stats(cfg.tree)
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
