"""Index-backed KV-cache pager: the ΔTree on the serving hot path (port of
``repro.serving.pager``).

The (seq_id, logical_block) -> physical_page mapping is any map-capable
``repro_torch.api.Index`` (key = seq_id * max_blocks + block + 1, int32;
payload = page id).  Every decode step resolves block tables with a
wait-free batched lookup; page allocation is a batched insert; sequence
teardown is a batched delete.  ``PagerConfig.engine`` picks the read
engine of the block-table lookups (``"lockstep"``: the CUDA vEB walk on
the card); ``PagerConfig.maintenance`` the index's maintenance policy.

Two mutation surfaces, as in the JAX package: the *immediate* protocol
(``allocate`` / ``free_seq`` — one index update per call) and the *staged*
protocol (``stage_allocate`` / ``stage_free`` / ``apply_staged`` — host
bookkeeping now, one combined index update per scheduler step).  The host
bookkeeping (free list, ``seq_blocks``, the staged ops) is Python and
numpy; the index lives on ``device`` (``cuda`` unless the caller names
the CPU), and `block_tables` returns its table there, so the paged
attention kernel reads it without a round trip through the host.

`serving.sharded_pager` fans the same map out over a DeltaForest.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api import Index, OpBatch, make_index
from repro_torch.api.opbatch import OP_DELETE, OP_INSERT
from repro_torch.core.deltatree import TreeConfig
from repro_torch.obs import trace as TR


class PagerError(RuntimeError):
    """The pager's discipline was broken (arena exhausted, out of pages,
    a duplicate allocation, or a staged batch the index refused)."""


@dataclasses.dataclass(frozen=True)
class PagerConfig:
    num_pages: int = 4096
    page_size: int = 16
    max_blocks: int = 1024        # logical blocks per sequence
    tree_height: int = 7          # UB=127 ΔNodes (paper's best)
    engine: str = "scalar"        # SearchEngine for block-table lookups
    maintenance: str = "eager"    # index maintenance policy
    maint_high_water: int = 0     # drain maintenance when this many items
    #                               sit buffered (0 = no high-water trigger)

    @property
    def payload_bits(self) -> int:
        return max(int(np.ceil(np.log2(self.num_pages))), 1)

    @property
    def tree_config(self) -> TreeConfig:
        """The JAX package's tree config, but for the lockstep walks' round
        cap: ``max_dnodes``, a depth no arena exceeds.  The reference
        derives the cap from a balanced ΔNode depth (14 at the defaults),
        and the pager's ascending block keys chain ΔNodes deeper than that
        — the reference's lookups then miss mapped blocks and its updates
        lose items (ROADMAP.md, Queue 3).  Below the reference's cap both
        give the same answers."""
        # arena: every page mapped -> ~num_pages keys; half-dense ΔNodes
        need = max(64, int(4 * self.num_pages / (2 ** (self.tree_height - 1))))
        return TreeConfig(
            height=self.tree_height,
            max_dnodes=need,
            buf_cap=64,
            payload_bits=self.payload_bits,
            engine=self.engine,
            maintenance=self.maintenance,
            walk_rounds=need,
        )

    def make_index(self, device=None) -> Index:
        """Default index for this config (single-arena ΔTree, map mode) on
        ``device`` (``cuda`` when None)."""
        return make_index("deltatree", cfg=self.tree_config, device=device)


class DeltaPager:
    """Host-driven pager over any map-capable Index handle."""

    def __init__(self, cfg: PagerConfig, index: Index | None = None,
                 device=None):
        self.cfg = cfg
        self.index = index if index is not None else cfg.make_index(device)
        if not self.index.capability.map_mode:
            raise ValueError(
                f"pager needs a map-mode index, got {self.index!r} with "
                f"{self.index.capability}")
        self.free_pages = list(range(cfg.num_pages - 1, -1, -1))
        self.seq_blocks: dict[int, int] = {}   # seq -> allocated blocks
        self.pending = 0   # buffered items awaiting maintenance (I5' carry)
        self._staged: list[tuple[int, int, int]] = []  # (kind, key, payload)
        self._staged_pages: dict[int, list[int]] = {}  # seq -> pages (staged)
        self.stats = {"searches": 0, "inserts": 0, "deletes": 0, "hops": 0,
                      "flushes": 0, "maint_rebuilds": 0, "maint_expands": 0,
                      "maint_merges": 0, "combined": 0, "inline_maint": 0}
        # most recent ReadStats from a stats-collecting index (None when
        # the index does not collect): the metrics-export snapshot source
        self.last_read_stats = None

    # ---- key encoding ----
    def _key(self, seq_id, block) -> np.ndarray:
        return (np.asarray(seq_id, np.int64) * self.cfg.max_blocks
                + np.asarray(block, np.int64) + 1).astype(np.int32)

    # ---- index protocol ----
    def _lookup(self, keys: np.ndarray):
        """(found, payload, hops) tensors for a key batch (wait-free).  A
        stats-collecting index's trailing ReadStats is kept as
        ``last_read_stats`` for metrics export, not returned."""
        out = self.index.lookup(keys)
        if len(out) > 3:
            self.last_read_stats = out[3]
        return out[0], out[1], out[2]

    def _update(self, kinds: np.ndarray, keys: np.ndarray,
                payloads: np.ndarray):
        """Apply a batched insert/delete step; returns the per-op results
        as numpy.  ``stats["inline_maint"]`` accumulates the structural
        maintenance these update batches paid on the decode path."""
        self.index, res, mstats = self.index.update(
            OpBatch.mixed(kinds, keys, payloads))
        if mstats is not None:
            self.pending = int(mstats.pending)
            self.stats["inline_maint"] += (
                int(mstats.rebuilds) + int(mstats.expands)
                + int(mstats.merges))
        if self.index.alloc_failed():
            raise PagerError("pager index arena exhausted")
        return res.cpu().numpy()

    def _pop_pages(self, n_blocks: int) -> list[int]:
        if len(self.free_pages) < n_blocks:
            raise PagerError(f"pager OOM: {n_blocks} pages asked, "
                             f"{len(self.free_pages)} free")
        return [self.free_pages.pop() for _ in range(n_blocks)]

    # ---- mutations ----
    def allocate(self, seq_id: int, n_blocks: int) -> list[int]:
        """Allocate pages for logical blocks [cur, cur + n_blocks)."""
        start = self.seq_blocks.get(seq_id, 0)
        pages = self._pop_pages(n_blocks)
        keys = self._key(seq_id, np.arange(start, start + n_blocks))
        kinds = np.full(len(pages), OP_INSERT, np.int32)
        res = self._update(kinds, keys, np.asarray(pages, np.int32))
        if not res.all():
            raise PagerError("duplicate block allocation")
        self.seq_blocks[seq_id] = start + n_blocks
        self.stats["inserts"] += n_blocks
        return pages

    def free_seq(self, seq_id: int) -> None:
        n = self.seq_blocks.pop(seq_id, 0)
        if n == 0:
            return
        keys = self._key(seq_id, np.arange(n))
        found, pages, _ = self._lookup(keys)
        if not bool(found.all()):
            raise PagerError(f"sequence {seq_id} lost a block mapping")
        kinds = np.full(n, OP_DELETE, np.int32)
        res = self._update(kinds, keys, np.zeros(n, np.int32))
        if not res.all():
            raise PagerError(f"sequence {seq_id}: a block delete failed")
        self.free_pages.extend(pages.tolist())
        self.stats["deletes"] += n

    # ---- staged mutations (the serve scheduler's protocol) ----

    def stage_allocate(self, seq_id: int, n_blocks: int) -> list[int]:
        """Page accounting now (free-list pop, block-count bump); the index
        inserts are staged for the step's one combined ``apply_staged``."""
        start = self.seq_blocks.get(seq_id, 0)
        pages = self._pop_pages(n_blocks)
        keys = self._key(seq_id, np.arange(start, start + n_blocks))
        self._staged.extend(
            (OP_INSERT, int(k), int(p)) for k, p in zip(keys, pages))
        self._staged_pages.setdefault(seq_id, []).extend(pages)
        self.seq_blocks[seq_id] = start + n_blocks
        self.stats["inserts"] += n_blocks
        return pages

    def stage_free(self, seq_id: int) -> None:
        """``free_seq`` for staged sequences: pages return to the free list
        now, the index deletes ride the next ``apply_staged`` batch (no
        lookup: the staged protocol tracks each sequence's pages)."""
        n = self.seq_blocks.pop(seq_id, 0)
        if n == 0:
            return
        pages = self._staged_pages.pop(seq_id)
        if len(pages) != n:
            raise PagerError(f"sequence {seq_id}: {len(pages)} staged pages "
                             f"for {n} blocks")
        keys = self._key(seq_id, np.arange(n))
        self._staged.extend((OP_DELETE, int(k), 0) for k in keys)
        self.free_pages.extend(pages)
        self.stats["deletes"] += n

    def apply_staged(self, combine: bool = True) -> dict:
        """Apply all staged ops as ONE index update, after the same-key
        elimination pass (`repro_torch.serve.combine.combine_ops`) unless
        ``combine`` is False.  Batch order is preserved, so this is a valid
        linearization of the staged sequence.  Returns {"applied",
        "combined", "inline_maint"} for the step's stats."""
        from repro_torch.serve.combine import combine_ops

        if not self._staged:
            return {"applied": 0, "combined": 0, "inline_maint": 0}
        kinds, keys, pays = (np.asarray(c) for c in zip(*self._staged))
        self._staged.clear()
        combined = 0
        if combine:
            kinds, keys, pays, combined = combine_ops(kinds, keys, pays)
            self.stats["combined"] += combined
        inline0 = self.stats["inline_maint"]
        if len(kinds):
            res = self._update(kinds.astype(np.int32), keys.astype(np.int32),
                               pays.astype(np.int32))
            if not res.all():
                raise PagerError("staged batch violated the pager discipline")
        return {"applied": int(len(kinds)), "combined": combined,
                "inline_maint": self.stats["inline_maint"] - inline0}

    def flush(self):
        """Drain the index's pending maintenance (no-op under "eager").
        Returns the MaintenanceStats (or None)."""
        self.index, mstats = self.index.flush()
        if mstats is not None:
            self.pending = int(mstats.pending)
            self.stats["flushes"] += 1
            self.stats["maint_rebuilds"] += int(mstats.rebuilds)
            self.stats["maint_expands"] += int(mstats.expands)
            self.stats["maint_merges"] += int(mstats.merges)
        return mstats

    # ---- the decode-step hot path ----
    def block_tables(self, seq_ids, max_blocks: int) -> torch.Tensor:
        """(B, max_blocks) int32 physical page table (-1 unmapped) via one
        wait-free Index lookup, on the index's device."""
        seq_ids = np.asarray(seq_ids)
        b = len(seq_ids)
        keys = self._key(
            np.repeat(seq_ids, max_blocks),
            np.tile(np.arange(max_blocks), b),
        )
        with TR.span("pager.block_tables"):
            found, pages, hops = self._lookup(keys)
        self.stats["searches"] += len(keys)
        self.stats["hops"] += int(hops.sum())
        table = torch.where(found, pages, -1)
        return table.reshape(b, max_blocks).to(torch.int32)


def make_pager(cfg: PagerConfig, index: Index | None = None,
               device=None) -> DeltaPager:
    """Pager for a config on ``device``; ``index`` overrides the config's
    default backend (any map-capable handle)."""
    from repro_torch.serving.sharded_pager import (
        ShardedDeltaPager, ShardedPagerConfig,
    )

    if isinstance(cfg, ShardedPagerConfig):
        return ShardedDeltaPager(cfg, index, device)
    return DeltaPager(cfg, index, device)
