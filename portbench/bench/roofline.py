"""Roofline arithmetic of the ΔTree kernels: the bytes a walk or a scan
needs on given inputs, and the least time that many bytes take on one
NVIDIA H100 (SXM, 3.35 TB/s of HBM, NVIDIA's data sheet).

A frozen, self-contained copy of the byte counts of ``chip_smoke.py``'s
``pos_bytes``, ``fused_needs``, ``scan_needs`` and ``bound_ms``, with the
program constants they read copied beside them, so that no later change
to the program can move the yardstick.  Each byte a kernel needs is
counted once: every distinct (ΔNode, slot) router, child id and mark its
lanes read, plus its inputs, outputs and the vEB position table.  The
replays run as plain PyTorch on the tree's device, off the clock.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
SMEM_HEIGHT = 12            # veb::kSmemHeight: taller ΔNodes are read in place
ROUTE_LEFT = 2**31 - 1      # the int32 router sentinel (INT32_MAX)


def walk_big(dtype: torch.dtype) -> int:
    """The walk's resolved-lane sentinel: ROUTE_LEFT, or 1 << 62 for the
    packed int64 rows of map mode."""
    return 1 << 62 if dtype == torch.int64 else ROUTE_LEFT


def veb_order(h: int) -> list[int]:
    """BFS indices (1-based) of a height-``h`` tree in vEB storage order:
    the top half-height subtree, then each bottom subtree left to right."""
    if h == 1:
        return [1]
    ht, hb = h // 2, h - h // 2
    order = list(veb_order(ht))
    bot = veb_order(hb)
    for r in range(2**ht, 2 ** (ht + 1)):
        for j in bot:
            d = j.bit_length() - 1
            order.append(r * 2**d + (j - 2**d))
    return order


@functools.lru_cache(maxsize=None)
def _pos_np(height: int) -> np.ndarray:
    pos = np.full(2**height, -1, dtype=np.int32)
    for storage_idx, b in enumerate(veb_order(height)):
        pos[b] = storage_idx
    return pos


def pos_table(height: int, device) -> torch.Tensor:
    """``pos[b]``: the storage index of BFS node ``b`` (index 0 unused)."""
    return torch.as_tensor(_pos_np(height), device=device)


def pos_bytes(height: int, nodes) -> int:
    """Position-table bytes a kernel reads: up to ``SMEM_HEIGHT`` the
    whole table (staged a block), above it the entries of the distinct
    BFS nodes ``nodes`` (a list of index tensors) the lanes visit."""
    if height <= SMEM_HEIGHT:
        return 4 * 2 ** height
    return 4 * torch.unique(torch.cat(nodes)).numel() if nodes else 0


def fused_needs(t, height: int, q, roots, max_rounds: int) -> int:
    """Bytes the fused walk needs on these inputs: every distinct
    (ΔNode, slot) router and child id its lanes read, each once, plus
    queries, roots, outputs and the position table (`pos_bytes`).  A
    replay of the blind descent that records addresses."""
    pos = pos_table(height, q.device).long()
    m, ub = t.value.shape
    lc = t.child.shape[1]
    bottom0 = 2 ** (height - 1)
    vflat = t.value.reshape(-1)
    act = q != walk_big(t.value.dtype)
    dn = roots.long().clone()
    k = q.numel()
    vidx, cidx, nodes = [], [], []
    for _ in range(max_rounds):
        if not bool(act.any()):
            break
        lanes = act.nonzero()[:, 0]
        d = dn[lanes].clamp(0, m - 1)
        v = q[lanes]
        b = torch.ones_like(d)
        lb = torch.ones_like(d)
        for _ in range(height):
            addr = d * ub + pos[b]
            vidx.append(addr)
            nodes.append(b)
            router = vflat[addr]
            lb = torch.where(router != 0, b, lb)
            b = torch.where(b < bottom0, 2 * b + (v >= router).long(), b)
        bottom = lb >= bottom0
        caddr = d * lc + (lb - bottom0).clamp(min=0)
        cidx.append(caddr[bottom])
        nxt = torch.where(bottom, t.child.reshape(-1)[caddr].long(), -1)
        dn[lanes] = torch.where(nxt >= 0, nxt, dn[lanes])
        act[lanes] = nxt >= 0
    isz = t.value.element_size()
    distinct_v = torch.unique(torch.cat(vidx)).numel() if vidx else 0
    distinct_c = torch.unique(torch.cat(cidx)).numel() if cidx else 0
    nbytes = (distinct_v * isz + distinct_c * 4 + k * (isz + 4)
              + k * (2 * isz + 3 * 4) + pos_bytes(height, nodes))
    return nbytes


def scan_needs(t, height: int, roots, starts, his, max_out: int,
               pmask: int, max_rounds: int) -> int:
    """Bytes the scan kernel needs on these inputs: every distinct router
    slot, child id and mark its lanes read, each once, plus roots, bounds,
    outputs and the position table.  A replay of the scan's FIND / VERIFY
    passes that records addresses."""
    pos = pos_table(height, starts.device).long()
    m, ub = t.value.shape
    lc = t.child.shape[1]
    bottom0 = 2 ** (height - 1)
    big = walk_big(t.value.dtype)
    vflat, mflat, cflat = (t.value.reshape(-1), t.mark.reshape(-1),
                           t.child.reshape(-1))
    dn0 = roots.long()
    dn = dn0.clone()
    verify = torch.zeros_like(starts, dtype=torch.bool)
    q, cursor = starts.clone(), starts.clone()
    cand = torch.full_like(starts, big)
    n = torch.zeros_like(starts, dtype=torch.int32)
    done = starts == big
    vidx, cidx, midx, nodes = [], [], [], []
    for _ in range(max_rounds):
        if bool(done.all()):
            break
        ln = (~done).nonzero()[:, 0]
        d = dn[ln].clamp(0, m - 1)
        v, ver, cur, c = q[ln], verify[ln], cursor[ln], cand[ln]
        b = torch.ones_like(d)
        lb = torch.ones_like(d)
        lv = torch.zeros_like(v)
        routers, bs = [], []
        for _ in range(height):
            addr = d * ub + pos[b]
            vidx.append(addr)
            nodes.append(b)
            router = vflat[addr]
            routers.append(router)
            bs.append(b)
            lb = torch.where(router != 0, b, lb)
            lv = torch.where(router != 0, router, lv)
            b = torch.where(b < bottom0, 2 * b + (v >= router).long(), b)
        rcand = torch.full_like(v, big)
        for router, bi in zip(routers, bs):
            fold = (router != 0) & (bi != lb) & (v < router) & (router < rcand)
            rcand = torch.where(fold, router, rcand)
        bottom = lb >= bottom0
        caddr = d * lc + (lb - bottom0).clamp(min=0)
        cidx.append(caddr[bottom])
        nxt = torch.where(bottom, cflat[caddr].long(), -1)
        c = torch.where(~ver & (rcand < c), rcand, c)
        res = nxt < 0
        maddr = d * ub + pos[lb]
        midx.append(maddr[res])
        live = (lv != 0) & ~mflat[maddr]
        f_res = res & ~ver
        c = torch.where(f_res & live & (lv > cur) & (lv < c), lv, c)
        f_none = f_res & ((c == big) | (c > his[ln]))
        to_v = f_res & ~f_none
        v_res = res & ver
        hit = v_res & live & ((lv | pmask) == v)
        emit = hit & (n[ln] < max_out)
        full = hit & ~emit
        back = emit | (v_res & ~hit)
        restart = to_v | back
        dn[ln] = torch.where(nxt >= 0, nxt, torch.where(restart, dn0[ln],
                                                         dn[ln]))
        cursor[ln] = torch.where(back, v, cur)
        q[ln] = torch.where(to_v, c | pmask, v)
        verify[ln] = (ver | to_v) & ~back
        cand[ln] = torch.where(restart, big, c)
        n[ln] += emit.to(torch.int32)
        done[ln] = f_none | full
    isz = t.value.element_size()
    k = starts.numel()

    def distinct(idx):
        return torch.unique(torch.cat(idx)).numel() if idx else 0

    nbytes = (distinct(vidx) * isz + distinct(cidx) * 4 + distinct(midx)
              + k * (4 + 2 * isz) + k * max_out * isz + k * (4 + 4 + 1)
              + pos_bytes(height, nodes))
    return nbytes


def bound_ms(nbytes: int) -> float:
    """The least time ``nbytes`` of HBM traffic take, in milliseconds."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def read_windows(host) -> list:
    """(start, end) of each step's read on the host timeline: from its
    ``client.read`` span's start to its ``client.read_copy`` span's end,
    which waits for the read's kernels.  An update's kernels (the
    maintenance scheduler's position walks among them) start later."""
    starts = [s for s, _, n in host if n == "client.read"]
    ends = [e for _, e, n in host if n == "client.read_copy"]
    return list(zip(starts, ends))


def kernel_share(run, nbytes: int | None, kernel: str) -> float | None:
    """Percent of the roofline: the bound of ``nbytes`` (what the last
    read batch of the profiled stretch needs) over the profiler's time of
    the last launch of ``kernel`` by a read in it."""
    if not nbytes:
        return None
    wins = [(a, b) for a, b in read_windows(run.host_events)
            if run.slice_lo <= a <= run.slice_hi]
    kern = [(s, e) for s, e, n in run.dev_events
            if kernel in n and any(a <= s <= b for a, b in wins)]
    if not kern:
        return None
    s, e = kern[-1]
    return 100.0 * bound_ms(nbytes) / ((e - s) / 1e3)
