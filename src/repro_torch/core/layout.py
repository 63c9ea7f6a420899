"""Dynamic van Emde Boas layout math (paper §2).

A ΔNode is a size-fixed container holding a complete binary tree of height
``H`` (``UB = 2**H - 1`` node slots) stored in **vEB order**: the tree is
recursively split at half height into a top subtree and bottom subtrees, each
laid out contiguously (paper Fig. 1/2).  We address tree nodes by their
1-based **BFS index** ``b`` (root=1, children ``2b``/``2b+1``) and translate
to the storage position with a precomputed permutation table: the
complete-tree *shape* is implicit (position arithmetic in registers), only
*occupancy* is dynamic, so no child pointers are stored inside a ΔNode
(fewer bytes transferred than the paper's explicit-pointer nodes; see
DESIGN.md §2).

The port's own copy of ``repro.core.layout`` (numpy only, so the PyTorch
package never imports the JAX one).  The tables are host constants: the
ΔTree code indexes them on the host, and the CUDA walk kernels receive the
position table as a small device array that each block stages in shared
memory.
"""

from __future__ import annotations

import functools

import numpy as np

# Reserved key values (paper reserves 0 as EMPTY; we additionally reserve the
# int32 max as the "route-everything-left" router used by Merge splicing).
EMPTY = np.int32(0)
ROUTE_LEFT = np.int32(2**31 - 1)  # INT32_MAX
KEY_MIN = 1
KEY_MAX = 2**31 - 2


def veb_order(h: int) -> list[int]:
    """BFS indices (1-based, within a height-``h`` subtree) in vEB storage order.

    Recursive split: top subtree of height ``h//2``, ``2**(h//2)`` bottom
    subtrees of height ``h - h//2``, laid out top-first then bottoms
    left-to-right (paper §2.2).  Works for any ``h >= 1`` (the paper assumes
    ``h`` a power of two "for simplicity"; the recursion does not need it).
    """
    if h == 1:
        return [1]
    ht = h // 2          # top height
    hb = h - ht          # bottom height
    top = veb_order(ht)
    bot = veb_order(hb)
    order = list(top)
    # Bottom subtree roots are the BFS nodes at depth ht: indices 2**ht .. 2**(ht+1)-1.
    for r in range(2**ht, 2 ** (ht + 1)):
        for j in bot:
            # local BFS index j (root=1) inside subtree rooted at global BFS r:
            # j at local depth d with offset (j - 2**d)  ->  global r*2**d + offset.
            d = j.bit_length() - 1
            order.append(r * (2**d) + (j - 2**d))
    return order


@functools.lru_cache(maxsize=None)
def veb_pos_table(h: int) -> np.ndarray:
    """``pos[b]`` = storage index (0-based) of BFS node ``b``; shape (2**h,).

    Index 0 is unused (BFS is 1-based) and set to -1.
    """
    order = veb_order(h)
    pos = np.full(2**h, -1, dtype=np.int32)
    for storage_idx, b in enumerate(order):
        pos[b] = storage_idx
    assert (pos[1:] >= 0).all()
    return pos


@functools.lru_cache(maxsize=None)
def veb_inverse_table(h: int) -> np.ndarray:
    """``bfs[s]`` = BFS index stored at storage position ``s``; shape (2**h - 1,)."""
    return np.asarray(veb_order(h), dtype=np.int32)


def num_nodes(h: int) -> int:
    return 2**h - 1


def leaf_capacity(h: int) -> int:
    """Max leaves of a complete tree of height ``h`` (bottom row)."""
    return 2 ** (h - 1)


def bottom_first(h: int) -> int:
    """BFS index of the first bottom-row node."""
    return 2 ** (h - 1)


# ---------------------------------------------------------------------------
# Complete leaf-oriented BST (re)build tables (used by Rebalance / Expand /
# Merge / bulk build).  Given m sorted leaf values placed contiguously at
# depth d (0-based; leaves at BFS 2**d .. 2**d + m - 1), every internal node
# at depth dd < d covers the leaf range [j*2**(d-dd), (j+1)*2**(d-dd)) where
# j is its offset within its row, and its *router* is the minimum of its right
# half ( = leaf x[j*c + c/2] ), with the leaf-oriented rule "v < router goes
# left, else right" (paper Fig. 8 semantics — see DESIGN.md for the min-of-
# right-subtree derivation from the paper's grow-leaf, Fig. 9 lines 52..66).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def rebuild_tables(h: int) -> dict[str, np.ndarray]:
    """Static tables for rebuilding a ΔNode at any leaf depth d in 0..h-1.

    Returns arrays of shape (h, 2**h):
      - ``range_start[d, b]``: first covered leaf index of BFS node b when
        leaves live at depth d (or a large sentinel when b is below depth d).
      - ``range_mid[d, b]``:   leaf index whose value is the router of b.
      - ``kind[d, b]``: 0 = below-leaf-row (always EMPTY), 1 = leaf row,
        2 = internal row.
    All indexed by BFS node; callers translate with :func:`veb_pos_table`.
    """
    n = 2**h
    range_start = np.full((h, n), 2**30, dtype=np.int32)
    range_mid = np.full((h, n), 2**30, dtype=np.int32)
    kind = np.zeros((h, n), dtype=np.int32)
    for d in range(h):
        for b in range(1, n):
            dd = b.bit_length() - 1  # depth of b
            j = b - 2**dd            # offset within its row
            if dd > d:
                kind[d, b] = 0
            elif dd == d:
                kind[d, b] = 1
                range_start[d, b] = j
            else:
                kind[d, b] = 2
                c = 2 ** (d - dd)    # leaves covered
                range_start[d, b] = j * c
                range_mid[d, b] = j * c + c // 2
    return {"range_start": range_start, "range_mid": range_mid, "kind": kind}


def rebuild_values_np(h: int, sorted_vals: np.ndarray, m: int,
                      force_bottom: bool = False, dtype=np.int32,
                      route_left=None) -> np.ndarray:
    """Numpy oracle of the ΔNode rebuild (mirrors the jnp version in
    deltatree.py).  Returns the (2**h - 1,) storage array in vEB order.

    ``sorted_vals`` holds the m live (packed) keys in ascending order (padded
    arbitrarily beyond m).  Leaves are placed at the minimal depth
    ``d = ceil(log2(max(m,1)))`` unless ``force_bottom`` (ΔNodes that carry
    child links keep their leaf row pinned at the bottom; DESIGN.md §2).
    """
    if route_left is None:
        route_left = ROUTE_LEFT
    n = 2**h
    if m <= 0:
        return np.full(n - 1, EMPTY, dtype=dtype)
    d = int(np.ceil(np.log2(max(m, 1)))) if m > 1 else 0
    d = min(d, h - 1)
    if force_bottom:
        d = h - 1
    assert m <= 2**d or m == 1
    t = rebuild_tables(h)
    pos = veb_pos_table(h)
    out = np.full(n - 1, EMPTY, dtype=dtype)
    for b in range(1, n):
        k = t["kind"][d, b]
        if k == 1:
            idx = t["range_start"][d, b]
            if idx < m:
                out[pos[b]] = sorted_vals[idx]
        elif k == 2:
            start = t["range_start"][d, b]
            mid = t["range_mid"][d, b]
            if start >= m:
                continue  # whole subtree empty
            if mid < m:
                out[pos[b]] = sorted_vals[mid]   # min of right subtree
            else:
                out[pos[b]] = route_left         # right subtree empty
    return out
