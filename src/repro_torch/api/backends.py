"""Built-in Index backends (port of ``repro.api.backends``).

So far only ``deltatree`` — the paper's structure, one arena on one device.
The forest, the sorted-array and the paper's comparison structures are
later slices of the port (ROADMAP.md).
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
from repro_torch.maintenance.policy import KINDS
from repro_torch.maintenance.scheduler import require_eager


def _dt_make(initial, payloads, cfg=None, device=None, **kw):
    if cfg is None:
        cfg = TreeConfig(**kw)
    elif kw:
        cfg = dataclasses.replace(cfg, **kw)
    require_eager(cfg.maintenance)
    if cfg.collect_stats or cfg.collect_transfers:
        raise NotImplementedError(
            "collect_stats is not ported to repro_torch yet (see ROADMAP.md)")
    if initial is None:
        return cfg, DT.empty(cfg, device)
    return cfg, DT.bulk_build(cfg, np.asarray(initial), payloads, device)


def _dt_update(cfg, t, batch: OpBatch):
    batch = batch.to(t.value.device)
    return DT.update_batch(cfg, t, batch.kinds, batch.keys, batch.payloads)


def _dt_size(cfg, t) -> int:
    # between steps every live item is a live leaf or a buffered entry
    # (never both), so nlive + bcount over live ΔNodes is exact
    return int(torch.where(t.alive, t.nlive + t.bcount, 0).sum())


register_backend(BackendSpec(
    name="deltatree",
    make=_dt_make,
    capability=lambda cfg: Capability(
        map_mode=cfg.payload_bits > 0, successor=True, sharded=False,
        deferred_maintenance=False, range_scan=False, successor_k=False),
    search=DT.search_batch,
    lookup=DT.lookup_batch,
    update=_dt_update,
    successor=DT.successor_batch,
    live_items=DT.live_items,
    size=_dt_size,
    alloc_failed=lambda cfg, t: bool(t.alloc_fail),
    flush=DT.flush,
    engines=("*",),   # reads dispatch on cfg.engine: any registered engine
    maintenance=KINDS,  # the non-eager kinds raise NotImplementedError
))
