"""Ideal-cache transfer accounting for the ΔTree (Table 1 / Lemma 2.1
analog; port of ``repro.core.transfers``).

The paper measures cache misses with Valgrind; here, as in the JAX package,
memory transfers are counted exactly in the ideal-cache model the paper's
analysis uses: replay the search path on the host, record every element
index read, and count distinct B-element blocks
(`core.baselines.count_block_transfers`).

The flat address space models the arena layout: ΔNode ``dn`` occupies
elements ``[dn*stride, dn*stride + UB)`` with the vEB permutation inside,
the bytes one read of that ΔNode row moves.  The arena is copied to the
host once per call of `delta_touch_fn`.
"""

from __future__ import annotations

from repro_torch.core import layout
from repro_torch.core.deltatree import DeltaTree, TreeConfig
from repro_torch.core.layout import EMPTY


def delta_touch_fn(cfg: TreeConfig, t: DeltaTree):
    """Host replay of `deltatree._descend` returning touched flat element
    indices (for `baselines.count_block_transfers`)."""
    pos = layout.veb_pos_table(cfg.height)
    value = t.value.cpu().numpy()
    child = t.child.cpu().numpy()
    root = int(t.root)
    bottom0 = cfg.bottom0
    stride = cfg.ub  # contiguous rows; block-aligned per ΔNode

    def touched(key: int) -> list[int]:
        q = cfg.qpack(key)
        dn, b, out = root, 1, []
        while True:
            out.append(dn * stride + int(pos[b]))
            if b >= bottom0:
                ch = child[dn, b - bottom0]
                if ch >= 0:
                    dn, b = int(ch), 1
                    continue
                break
            left_val = value[dn, pos[2 * b]]
            if left_val == EMPTY:
                break  # leaf
            out.append(dn * stride + int(pos[2 * b]))  # leaf-test read
            b = 2 * b + (1 if q >= value[dn, pos[b]] else 0)
        return out

    return touched


def delta_hops_fn(cfg: TreeConfig, t: DeltaTree):
    """ΔNode-visit count per search (each visit ≤ 2 block transfers of size
    ≥ UB, Lemma 2.1)."""
    touch = delta_touch_fn(cfg, t)
    stride = cfg.ub

    def hops(key: int) -> int:
        return len({i // stride for i in touch(key)})

    return hops
