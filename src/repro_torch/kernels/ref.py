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


def ref_delta_scan_fused(value: torch.Tensor, mark: torch.Tensor,
                         child: torch.Tensor, root, starts: torch.Tensor,
                         his: torch.Tensor, *, height: int, max_rounds: int,
                         max_out: int, pmask: int = 0):
    """The emit-cursor range scan over the arena (value/mark (M, UB),
    child (M, leaf_cap)): the contract of ``ops.delta_scan``.

    Each lane carries an emit cursor over the packed key space and fills
    ``out[lane, :]`` with the live *leaf* values in ``(start, hi]`` in key
    order (packed, ascending; ``walk_big`` pads unused slots).  ``starts``
    and ``his`` are packed ``qpack`` bounds: start exclusive, hi inclusive
    in key space (``v > start_q`` iff ``key(v) > start_key``, since qpack
    packs an all-ones payload).  A lane alternates two pass kinds over the
    round structure of `ref_delta_walk_fused` (one blind descent per
    round, then the child hop):

    * FIND — a successor walk from the root for the cursor, folding
      left-turn routers plus the final live leaf into a candidate; no
      candidate, or one above ``hi``, ends the lane;
    * VERIFY — an exact walk for the candidate key (candidate routers may
      be tombstones): a live hit is emitted and becomes the new cursor, or
      sets ``more`` when the row is full; a dead one is chased (the cursor
      moves past it without emitting).

    Overflow buffers are not read: the engine dispatch merges I5'
    buffered items into the emitted run (`repro_torch.core.engine`).

    Returns (out (K, max_out) packed, n (K,) int32, hops (K,) int32, more
    (K,) bool).  ``hops`` counts the rounds each lane stayed active (ΔNode
    visits over every pass).  A lane whose start equals ``walk_big`` is
    born done; a lane still running after ``max_rounds`` rounds keeps its
    partial row with ``more`` False.
    """
    ref_delta_scan_fused.calls += 1
    h = height
    bottom0 = 2 ** (h - 1)
    m, ub = value.shape
    dev = value.device
    pos = pos_table(h, dev).long()
    big = walk_big(value.dtype)
    starts = starts.to(value.dtype)
    his = his.to(value.dtype)
    k = starts.shape[0]
    vflat = value.reshape(-1)
    mflat = mark.reshape(-1)
    dn0 = torch.as_tensor(root, dtype=torch.int32, device=dev).expand(k)
    dn = dn0.clone()
    verify = torch.zeros(k, dtype=torch.bool, device=dev)
    q = starts.clone()              # FIND: the cursor; VERIFY: the candidate
    cursor = starts.clone()         # start, then the last emitted (qpack)
    cand = torch.full((k,), big, dtype=value.dtype, device=dev)
    out = torch.full((k, max_out), big, dtype=value.dtype, device=dev)
    n = torch.zeros(k, dtype=torch.int32, device=dev)
    hops = torch.zeros(k, dtype=torch.int32, device=dev)
    more = torch.zeros(k, dtype=torch.bool, device=dev)
    done = starts == big            # sentinel lanes are born done
    rounds = 0
    while rounds < max_rounds and not bool(done.all()):
        dnc = dn.clamp(0, m - 1).long()
        base = dnc * ub
        b = torch.ones(k, dtype=torch.int64, device=dev)
        lb = torch.ones(k, dtype=torch.int64, device=dev)
        lv = torch.zeros(k, dtype=value.dtype, device=dev)
        routers, bs = [], []
        for _ in range(h):                       # blind descent
            router = vflat[base + pos[b]]
            routers.append(router)
            bs.append(b)
            occ = router != EMPTY
            lb = torch.where(occ, b, lb)
            lv = torch.where(occ, router, lv)
            b = torch.where(b < bottom0, 2 * b + (q >= router).long(), b)
        rcand = torch.full((k,), big, dtype=value.dtype, device=dev)
        for router, bi in zip(routers, bs):      # post-hoc candidate fold
            fold = ((router != EMPTY) & (bi != lb) & (q < router)
                    & (router < rcand))
            rcand = torch.where(fold, router, rcand)
        at_bottom = lb >= bottom0
        slot = torch.where(at_bottom, lb - bottom0, 0)
        nxt = torch.where(at_bottom, child[dnc, slot], -1).to(torch.int32)
        act = ~done
        hopping = act & (nxt >= 0)
        res = act & (nxt < 0)                    # the pass resolved
        cand = torch.where(act & ~verify & (rcand < cand), rcand, cand)
        leaf_live = (lv != EMPTY) & ~mflat[base + pos[lb]]
        # FIND resolution: fold the final leaf, then stop or verify
        f_res = res & ~verify
        leaf_fold = f_res & leaf_live & (lv > cursor) & (lv < cand)
        cand = torch.where(leaf_fold, lv, cand)
        f_none = f_res & ((cand == big) | (cand > his))
        to_verify = f_res & ~f_none
        # VERIFY resolution: emit a live hit, chase a tombstone
        v_res = res & verify
        hit = v_res & leaf_live & ((lv | pmask) == q)
        can_emit = n < max_out
        emit = hit & can_emit
        full = hit & ~can_emit
        chase = v_res & ~hit
        rows = emit.nonzero()[:, 0]
        out[rows, n[rows].long()] = lv[rows]
        back_to_find = emit | chase
        restart = to_verify | back_to_find
        dn = torch.where(hopping, nxt, torch.where(restart, dn0, dn))
        cursor = torch.where(back_to_find, q, cursor)
        q = torch.where(to_verify, cand | pmask, q)
        verify = (verify | to_verify) & ~back_to_find
        cand = torch.where(restart, big, cand)
        n = n + emit.to(torch.int32)
        hops = hops + act.to(torch.int32)
        more = more | full
        done = done | f_none | full
        rounds += 1
    return out, n, hops, more


ref_delta_scan_fused.calls = 0


def ref_paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               seq_lens: torch.Tensor) -> torch.Tensor:
    """ΔTree-paged GQA decode attention with the *kernel's* semantics.

    q (B, QH, D); k/v_pages (NP, PS, KVH, D); block_tables (B, MAXP) int32
    (-1 unused); seq_lens (B,) int32.  Returns (B, QH, D) in q.dtype.

    Gathers each sequence's pages (a -1 entry clamps to page 0, as the
    TPU kernel's DMA does; the mask hides it), scores in float32 scaled by
    1/sqrt(D), masks tokens at or past ``seq_len`` with -1e30, and returns
    ``acc / max(l, 1e-30)`` with the masked weights zeroed.  A sequence of
    length 0 therefore gives 0, as the Pallas kernel and the CUDA kernel
    do (``repro.kernels.ref.ref_paged_decode_attention`` gives NaN there:
    its softmax runs over an all -inf row).
    """
    ref_paged_decode_attention.calls += 1
    b, qh, d = q.shape
    _, ps, kvh, _ = k_pages.shape
    maxp = block_tables.shape[1]
    g = qh // kvh
    bt = torch.clamp(block_tables.long(), min=0)
    k = k_pages[bt].reshape(b, maxp * ps, kvh, d).float()
    v = v_pages[bt].reshape(b, maxp * ps, kvh, d).float()
    qf = q.reshape(b, kvh, g, d).float()
    s = torch.einsum("bhgd,bshd->bhgs", qf, k) * (1.0 / d ** 0.5)
    valid = (torch.arange(maxp * ps, device=q.device)[None, :]
             < seq_lens.long()[:, None])[:, None, None, :]   # (B,1,1,S)
    s = torch.where(valid, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1)                                       # (B,KVH,G)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, qh, d).to(q.dtype)


ref_paged_decode_attention.calls = 0
