"""Sharded pager: the (seq_id, block) map fanned out over a DeltaForest
(port of ``repro.serving.sharded_pager``).

Same protocol as `DeltaPager` (allocate / free_seq / block_tables, and the
staged protocol) — a subclass that swaps the default Index backend and the
key encoding, nothing else.  Seq ids are assigned *sequentially*, so
sharding their natural key encoding by range would pile every live
sequence into shard 0; the key encoding band-interleaves sequences
instead:

    shard  = seq_id mod S                    (round-robin across shards)
    key    = shard * band + (seq_id div S) * max_blocks + block + 1
    band   = ceil(max_seqs / S) * max_blocks (one shard's contiguous range)

Each shard owns one contiguous key band — exactly the forest's equi-width
partition over [1, S*band] — while consecutive seq ids land on different
shards, so per-shard load stays balanced for any window of active
sequences.  Under a ``torch.distributed`` process group the forest's
shards spread over the ranks: every rank makes the same pager and the
same calls, holds its own shards' arenas, and reads the same block tables
(the free list and the sequences' blocks are host state, replicated).
Without one, all shards live on the pager's one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.api import Index, make_index
from repro_torch.distributed.forest import ForestConfig
from repro_torch.serving.pager import DeltaPager, PagerConfig


@dataclasses.dataclass(frozen=True)
class ShardedPagerConfig(PagerConfig):
    """``PagerConfig`` plus the shard count and ``max_seqs``, which the
    band encoding needs (the single-tree pager does not)."""

    max_seqs: int = 256
    num_shards: int = 4

    @property
    def seqs_per_shard(self) -> int:
        return -(-self.max_seqs // self.num_shards)

    @property
    def band(self) -> int:
        """Width of one shard's contiguous key range."""
        return self.seqs_per_shard * self.max_blocks

    @property
    def forest_config(self) -> ForestConfig:
        """Per-shard arena: round-robin placement keeps shards balanced, so
        ~num_pages/S mapped keys each; 8x half-dense headroom (2x the
        single-tree pager's) absorbs moderate imbalance.  The walk round
        cap follows the arena (``walk_rounds`` = the per-shard
        ``max_dnodes``, a depth no shard exceeds), so a sequence whose
        ascending block keys chain ΔNodes deeper than a balanced tree's
        depth still resolves every block."""
        per_shard = max(
            64, int(8 * self.num_pages / self.num_shards
                    / (2 ** (self.tree_height - 1))))
        tcfg = dataclasses.replace(self.tree_config, max_dnodes=per_shard,
                                   walk_rounds=per_shard)
        return ForestConfig(
            num_shards=self.num_shards,
            tree=tcfg,
            key_min=1,
            key_max=self.num_shards * self.band,
        )

    def make_index(self, device=None) -> Index:
        """The default index on ``device`` (``cuda`` when None); the
        equi-width splits over [1, S*band] are the band boundaries."""
        return make_index("forest", cfg=self.forest_config, device=device)


class ShardedDeltaPager(DeltaPager):
    """Drop-in `DeltaPager` whose default index is a DeltaForest."""

    cfg: ShardedPagerConfig

    def _key(self, seq_id, block) -> np.ndarray:
        seq_id = np.asarray(seq_id, np.int64)
        # beyond S*seqs_per_shard the band encoding stops being injective:
        # fail loudly instead of colliding across bands
        if not (seq_id < self.cfg.num_shards
                * self.cfg.seqs_per_shard).all():
            raise ValueError(
                "seq_id exceeds max_seqs capacity of the sharded pager")
        shard = seq_id % self.cfg.num_shards
        lane = seq_id // self.cfg.num_shards
        return (shard * self.cfg.band + lane * self.cfg.max_blocks
                + np.asarray(block, np.int64) + 1).astype(np.int32)
