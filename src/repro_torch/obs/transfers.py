"""Measured memory-transfer accounting (port of ``repro.obs.transfers``).

`core.transfers.delta_touch_fn` is the *analytical* side of the paper's
Table 1: a host replay of the descent that yields the flat element indices
an ideal cache would fetch.  This module is the *measured* side: the same
replay as a fixed-length loop of tensor ops over the arena on its device,
so the dispatch layers (`core.engine`, `distributed.forest`) derive a
``TransferStats`` from exactly the inputs the walk consumed — (arena,
roots, shard ids, keys) — for every engine and dispatch.

The replay never looks at which engine produced the read result, so
cross-engine and cross-dispatch parity is structural.  It appends exactly
the indices the host model appends (the node read each micro-step; the
leaf-test read only when the left child is non-EMPTY; the terminal
leaf-test read not counted; SEARCHNODE's buffer probe kept out of the
block counts), so on a quiescent tree the measured distinct-block counts
equal `core.baselines.count_block_transfers` exactly.

Address space: per-shard flat indices ``dn * UB + vEB position`` (the
model's ``stride = cfg.ub``).  ROUTE_LEFT pad lanes are born resolved and
contribute zero touches, visits and blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.obs.stats import TRANSFER_BLOCK_SIZES, TransferStats

# sorts after every real flat index (``dn * UB + pos`` < 2**31 at every
# arena the port builds)
_SENTINEL = 2**31 - 1


def _replay(cfg, value, child, roots, sid, keys):
    """Replay each query's descent over stacked arenas.

    value (S, M, UB) packed, child (S, M, leaf_cap), roots[K] shard-local
    start ΔNodes, sid[K] owner-shard ids, keys[K] int32.  Returns
    (idx (K, 2T) int32 touched flat indices, SENTINEL-padded; visits[K],
    router[K], leaf[K] int32 per-query counts), T = ``walk_round_cap *
    height`` micro-steps (at most ``height`` per ΔNode visit).
    """
    from repro_torch.core import layout
    from repro_torch.kernels.ref import pos_table

    dev = value.device
    pos = pos_table(cfg.height, dev).to(torch.int32)
    bottom0, stride = cfg.bottom0, cfg.ub
    steps = cfg.walk_round_cap * cfg.height
    keys = torch.as_tensor(keys, dtype=torch.int32, device=dev)
    q = cfg.qpack(keys)
    sid = torch.as_tensor(sid, dtype=torch.int32, device=dev).long()
    dn = torch.as_tensor(roots, dtype=torch.int32, device=dev).clone()
    b = torch.ones_like(keys)          # b = 1; pos[0] is the -1 hole
    active = keys != int(layout.ROUTE_LEFT)
    visits = active.to(torch.int32)
    router_t = torch.zeros_like(keys)
    leaf_t = torch.zeros_like(keys)
    empty = torch.zeros((), dtype=value.dtype, device=dev)
    big = torch.full_like(keys, _SENTINEL)
    i1, i2 = [], []
    for step in range(steps):
        # a lane that stopped adds only SENTINEL entries from here on, so
        # once every lane has stopped the rest of the fixed-length replay
        # changes nothing: check once a ΔNode's worth of micro-steps
        if step and step % cfg.height == 0 and not bool(active.any()):
            break
        pos_b = pos[b.long()]
        node = value[sid, dn.long(), pos_b.long()]
        at_bottom = b >= bottom0
        slot = torch.where(at_bottom, b - bottom0, 0)
        ch = torch.where(at_bottom, child[sid, dn.long(), slot.long()], -1)
        hop = at_bottom & (ch >= 0)
        lpos = pos[torch.clamp(2 * b, max=2 * bottom0 - 1).long()]
        left_val = torch.where(at_bottom, empty,
                               value[sid, dn.long(), lpos.long()])
        internal = ~at_bottom & (left_val != int(layout.EMPTY))
        terminal = active & ~internal & ~hop
        i1.append(torch.where(active, dn * stride + pos_b, big))
        i2.append(torch.where(active & internal, dn * stride + lpos, big))
        b_next = torch.where(internal, 2 * b + (q >= node).to(torch.int32), b)
        b = torch.where(hop, 1, b_next)
        dn = torch.where(hop, ch, dn)
        visits += (active & hop).to(torch.int32)
        router_t += active.to(torch.int32) + (active & internal).to(torch.int32)
        leaf_t += terminal.to(torch.int32)
        active = active & ~terminal
    idx = torch.stack(i1 + i2, dim=1)  # (K, 2T)
    # every touch is counted once in router_t; the terminal read is the
    # leaf test that resolves the query: split it out of the router count
    return idx, visits, router_t - leaf_t, leaf_t


def _distinct_blocks(sorted_idx: torch.Tensor, block: int) -> torch.Tensor:
    """Per-query distinct ``block``-element blocks among the valid
    (non-SENTINEL) entries of an ascending-sorted (K, T) index array —
    exactly what `count_block_transfers` totals per key."""
    valid = sorted_idx < _SENTINEL
    bid = sorted_idx // block
    first = torch.cat([torch.ones_like(valid[:, :1]),
                       bid[:, 1:] != bid[:, :-1]], dim=1)
    return torch.sum(valid & first, dim=1, dtype=torch.int32)


def transfer_cols(cfg, value, child, roots, sid, keys) -> tuple:
    """The per-query columns of `measure_stacked`: (visits[K], router[K],
    leaf[K], blocks[K, len(TRANSFER_BLOCK_SIZES)]), all zero on sentinel
    lanes."""
    idx, visits, router_t, leaf_t = _replay(cfg, value, child, roots, sid,
                                            keys)
    sidx = torch.sort(idx, dim=1).values
    blocks = torch.stack([_distinct_blocks(sidx, b)
                          for b in TRANSFER_BLOCK_SIZES], dim=1)
    return visits, router_t, leaf_t, blocks


def measure_stacked(cfg, value, child, roots, sid, keys) -> TransferStats:
    """``TransferStats`` for one read batch over stacked (S, M, ...)
    arenas (the forest's owner-shard view; S = 1 for a single arena)."""
    pad = torch.as_tensor(keys, dtype=torch.int32,
                          device=value.device) == _SENTINEL
    return TransferStats.of(pad, *transfer_cols(cfg, value, child, roots,
                                                sid, keys))


def measure(cfg, t, keys) -> TransferStats:
    """``TransferStats`` for one read batch on a single arena ``t`` (what
    `engine._read_stats` threads through)."""
    keys = torch.as_tensor(keys, dtype=torch.int32, device=t.value.device)
    roots = t.root.to(torch.int32).expand(keys.shape)
    return measure_stacked(cfg, t.value[None], t.child[None], roots,
                           torch.zeros_like(keys), keys)


# ------------------------------------------------------------ validation ---


def compare_model(cfg, t, keys, block_sizes=TRANSFER_BLOCK_SIZES) -> dict:
    """Measured-vs-analytical distinct-block transfers on one tree.

    Returns ``{B: {"measured", "model", "ratio"}}``.  On a quiescent
    (flushed) tree the two sides count the identical index multiset, so
    ``ratio == 1.0`` exactly for every B.  Host-side helper.
    """
    from repro_torch.core import transfers as CT
    from repro_torch.core.baselines import count_block_transfers

    keys = np.asarray(keys.cpu() if hasattr(keys, "cpu") else keys)
    ts = measure(cfg, t, keys)
    blocks = ts.blocks.cpu().tolist()
    touch = CT.delta_touch_fn(cfg, t)
    out = {}
    for b in block_sizes:
        i = TRANSFER_BLOCK_SIZES.index(b)
        measured = int(blocks[i]) / max(len(keys), 1)
        model = count_block_transfers(touch, keys, b)
        out[int(b)] = {"measured": measured, "model": model,
                       "ratio": measured / model if model else 0.0}
    return out


def fit_log_b(n_points: int = 11, *, block: int = 16, height: int = 4,
              start: int = 128, factor: int = 2, queries: int = 512,
              seed: int = 0, device=None) -> dict:
    """Fit measured mean block transfers against c·log_B N + d across a
    geometric sweep of quiescent tree sizes.

    Builds ``n_points`` bulk trees of N = start·factor^i unique keys on
    ``device`` (``cuda`` when None), measures the mean distinct
    ``block``-element blocks per search over ``queries`` random probes,
    and least-squares fits the means against log_B N.  Returns {"block",
    "points": [(n, measured)], "c", "d", "r2"}; r2 ≥ 0.98 is the O(log_B N)
    acceptance gate.  Doubling N (factor=2) samples the staircase of mean
    ΔNode depth densely enough that the linear trend dominates.
    """
    from repro_torch.core import deltatree as DT
    from repro_torch.core import layout

    i = TRANSFER_BLOCK_SIZES.index(block)
    rng = np.random.default_rng(seed)
    points = []
    for p in range(n_points):
        n = start * factor**p
        keys = np.unique(rng.integers(
            layout.KEY_MIN, layout.KEY_MAX, size=n).astype(np.int32))
        cfg = DT.TreeConfig(
            height=height,
            max_dnodes=max(256, 6 * len(keys) // 2 ** (height - 1)))
        t = DT.bulk_build(cfg, keys, device=device)
        probes = rng.integers(layout.KEY_MIN, layout.KEY_MAX,
                              size=queries).astype(np.int32)
        ts = measure(cfg, t, probes)
        points.append((len(keys), int(ts.blocks[i]) / queries))
    x = np.log(np.asarray([n for n, _ in points], np.float64)) / np.log(block)
    y = np.asarray([m for _, m in points], np.float64)
    c, d = np.polyfit(x, y, 1)
    pred = c * x + d
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot else 1.0
    return {"block": int(block), "points": points, "c": float(c),
            "d": float(d), "r2": float(r2)}
