"""Plain PyTorch versions of the walk kernels (the CPU path and the card's
ground truth).

Each function has its kernel's signature and contract, bit for bit, and is
the port of the matching function in ``repro.kernels.ref``.  The wrappers in
`veb_search` call these for tensors on the CPU; on the card they are only
called by comparisons against the CUDA kernels.  Each counts its calls in a
plain integer attribute (``calls``) so a run can show that its main path
never reached them.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import layout
from repro_torch.core.layout import EMPTY


def walk_big(dtype: torch.dtype) -> int:
    """Successor-candidate identity for a row dtype — equals the tree's
    ROUTE_LEFT sentinel (int32: INT32_MAX; packed int64 map mode: 1 << 62)
    so candidate folding matches the scalar engine bit for bit."""
    if dtype == torch.int64:
        return 1 << 62
    return int(layout.ROUTE_LEFT)


def pos_table(height: int, device) -> torch.Tensor:
    """The vEB position table ``pos[b]`` (2**height,) int32 on ``device``
    (one copy per height and device, made at first use)."""
    return _pos_table(height, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _pos_table(height: int, device: str) -> torch.Tensor:
    return torch.as_tensor(layout.veb_pos_table(height), device=device)


def ref_veb_walk_rows(rows: torch.Tensor, childrows: torch.Tensor,
                      queries: torch.Tensor, *, height: int):
    """One full in-ΔNode descent per query over pre-gathered rows.

    rows (K, UBp) int32/int64, childrows (K, CP) int32, queries (K,) in the
    rows' dtype.  Returns (leaf_val, leaf_b, next_dn, cand), each (K,):
    next_dn = -1 when the walk ends inside this ΔNode; cand = min left-turn
    router (``walk_big`` when no left turn happened).
    """
    ref_veb_walk_rows.calls += 1
    pos = pos_table(height, rows.device).long()
    bottom0 = 2 ** (height - 1)
    big = walk_big(rows.dtype)

    def take(b):
        return torch.gather(rows, 1, pos[b][:, None])[:, 0]

    v = queries
    b = torch.ones(v.shape, dtype=torch.int64, device=rows.device)
    cand = torch.full(v.shape, big, dtype=rows.dtype, device=rows.device)
    for _ in range(height - 1):
        router = take(b)
        left = take(torch.clamp(2 * b, max=2 * bottom0 - 1))
        internal = (b < bottom0) & (left != EMPTY)
        go_right = v >= router
        go_left = internal & ~go_right
        cand = torch.where(go_left & (router < cand), router, cand)
        b = torch.where(internal, 2 * b + go_right.long(), b)

    leaf_val = take(b)
    at_bottom = b >= bottom0
    slot = torch.where(at_bottom, b - bottom0, 0)
    child = torch.gather(childrows, 1, slot[:, None])[:, 0]
    nxt = torch.where(at_bottom, child, -1).to(torch.int32)
    return leaf_val, b.to(torch.int32), nxt, cand


ref_veb_walk_rows.calls = 0


def ref_delta_walk_fused(value: torch.Tensor, child: torch.Tensor, root,
                         queries: torch.Tensor, *, height: int,
                         max_rounds: int):
    """All walk rounds over the arena (value (M, UB), child (M, leaf_cap)):
    the contract of ``ops.delta_walk`` — (leaf_val, leaf_b, final_dn, hops,
    cand) per query, ``root`` scalar or per-query (K,) seeds, and a query
    equal to ``walk_big(dtype)`` born resolved.

    Each round is a *blind* descent, one router load per level, always
    routing right through EMPTY territory (sound because occupied slots
    form a connected top tree and packed queries are >= 1 > EMPTY), so the
    last occupied position is the leaf the eager walk stops at.  The
    successor candidate is folded afterwards over the occupied positions
    above that leaf, which are exactly the internal ancestors.
    """
    ref_delta_walk_fused.calls += 1
    h = height
    bottom0 = 2 ** (h - 1)
    m, ub = value.shape
    dev = value.device
    pos = pos_table(h, dev).long()
    big = walk_big(value.dtype)
    v = queries.to(value.dtype)
    k = v.shape[0]
    vflat = value.reshape(-1)
    root = torch.as_tensor(root, dtype=torch.int32, device=dev)
    dn = root.expand(k).clone()
    resolved = v == big
    leaf_val = torch.zeros(k, dtype=value.dtype, device=dev)
    leaf_b = torch.ones(k, dtype=torch.int32, device=dev)
    final_dn = dn.clone()
    hops = torch.zeros(k, dtype=torch.int32, device=dev)
    cand = torch.full((k,), big, dtype=value.dtype, device=dev)
    rounds = 0
    while rounds < max_rounds and not bool(resolved.all()):
        dnc = dn.clamp(0, m - 1).long()
        base = dnc * ub
        b = torch.ones(k, dtype=torch.int64, device=dev)
        lb = torch.ones(k, dtype=torch.int64, device=dev)
        lv = torch.zeros(k, dtype=value.dtype, device=dev)
        routers, bs = [], []
        for _ in range(h):
            router = vflat[base + pos[b]]
            routers.append(router)
            bs.append(b)
            occ = router != EMPTY
            lb = torch.where(occ, b, lb)
            lv = torch.where(occ, router, lv)
            go_right = v >= router
            b = torch.where(b < bottom0, 2 * b + go_right.long(), b)
        rcand = torch.full((k,), big, dtype=value.dtype, device=dev)
        for router, bi in zip(routers, bs):
            fold = ((router != EMPTY) & (bi != lb) & (v < router)
                    & (router < rcand))
            rcand = torch.where(fold, router, rcand)
        at_bottom = lb >= bottom0
        slot = torch.where(at_bottom, lb - bottom0, 0)
        nxt = torch.where(at_bottom, child[dnc, slot], -1).to(torch.int32)
        act = ~resolved
        done_now = act & (nxt < 0)
        final_dn = torch.where(done_now, dn, final_dn)
        dn = torch.where(act & (nxt >= 0), nxt, dn)
        resolved = resolved | done_now
        leaf_val = torch.where(done_now, lv, leaf_val)
        leaf_b = torch.where(done_now, lb.to(torch.int32), leaf_b)
        hops = hops + act.to(torch.int32)
        cand = torch.where(act & (rcand < cand), rcand, cand)
        rounds += 1
    return leaf_val, leaf_b, final_dn, hops, cand


ref_delta_walk_fused.calls = 0
