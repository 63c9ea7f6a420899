#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero and prints no result line:

1. Card check: require CUDA, print the card's name and power limit
   (``nvidia-smi``), build and load the kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, all started
   together) and print the build seconds.
2. Each walk kernel against its plain PyTorch version, on the card, in set
   mode (int32) and map mode (int64, ``payload_bits=12``), over a tree of
   the Fig. 12 size after a few update batches and 2**16 queries (present
   and absent keys, walk sentinels, keys above every live key): integer
   outputs must be equal exactly; the same on small churned trees of
   heights 3, 4, 5, 8 and 12 (1, 2 and 4 vEB pieces a path), with per-lane
   roots and batches that leave a block part-full.  ``veb_walk_rows`` is
   checked in every round of the per-round walk, on the rows that walk
   gathers (each lane's current ΔNode, internal ones included).  nvcc's
   register, shared-memory and spill report of the walk instantiations.
   Times (CUDA events) of the kernel beside the design it replaced
   (``SIMPLE_WALK_MS``), the plain version and ``torch.searchsorted`` (a
   yardstick only: it answers membership over the sorted live keys, not
   the walk's outputs, and the port never calls it), the kernel's bound:
   the bytes the walk needs (every distinct router slot and child id it
   reads, queries, roots, outputs) over the card's 3.35 TB/s, and the
   dependent loads from device memory a lane makes, router by router as
   before and piece by piece now.  The walks do a few integer compares
   per loaded router, so bytes bound them.
   ``veb_scan_fused`` against its plain version on the same trees, over
   2**12 lanes that mix sparse, dense, empty (hi <= start) and
   past-the-last-key bands, bands that start just below tombstoned keys,
   sentinel lanes and per-lane roots at non-root ΔNodes, at ``max_out`` 16
   and 128 and with two round caps of both parities that truncate lanes
   (inside VERIFY and inside FIND passes): all four outputs must be equal
   exactly; the same on a height-3 tree whose paths run deeper than the
   kernel's 32-entry path stack (``tests/_torch_parity.deep_tree``'s
   tree).  nvcc's register, shared-memory and spill report of both scan
   instantiations.  Then timed at K = 512 (``benchmarks/scan_sweep.py
   --full``'s batch) for sparse / dense bands x ``max_out`` 16 / 128,
   beside the design it replaced (``SIMPLE_SCAN_MS``), the plain version,
   the bytes bound (distinct router, child-id and mark bytes the scan
   reads, inputs and outputs, over 3.35 TB/s) and a yardstick
   (``torch.searchsorted`` over the sorted live keys plus a
   ``max_out``-wide gather: the same rows on a tree without tombstones;
   the port never calls it).
3. The main path at the size of the paper's Fig. 12 big tree
   (``benchmarks/fig12_big_tree.py`` with ``benchmarks/common.py``
   ``backend_kwargs``): ``make_index("deltatree", engine="lockstep")`` over
   ~1.97 M keys (height 7, buf_cap 32, ~186 k ΔNodes, ~190 MB of arena),
   then 20 steps of 1024 ops at 10 % updates — ``ix.search`` on the batch, then
   ``ix.insert_delete`` on the whole batch — each checked against the set
   oracle, one 1024-key ``ix.successor`` batch, and the final live set and
   ``alloc_fail``.  Then 3 steps with ``walk_fused=False``, so the
   per-round walk runs ``veb_walk_rows``.  Range scans on the eager fused
   index after its steps: one K = 512 ``scan`` batch per (density,
   ``max_out``) cell above, one 1024-key ``ix.successor_k(keys, 16)`` batch
   and three ``ix.range_scan`` paginations followed by cursor to the end,
   each checked against the sorted oracle keys.
4. Deferred maintenance at the same size: ``make_index(...,
   maintenance="deferred")`` on the same keys, one batch of 1024 inserts in
   runs of consecutive keys (which fills overflow buffers; the uniform
   Fig. 12 mix alone almost never does), then 10 steps of 1024 ops at 10 %
   updates, each step's search, update results, one K = 512 scan batch and
   one successor batch checked against the oracle; every step must carry
   buffered items (``stats.pending > 0``), so the scans merged them.  Then
   ``flush()`` and the live set.  The same for 3 steps under
   ``budgeted:8``.
5. The serve path at Granite-8B width (``repro_torch.configs.granite_8b``):
   ``paged_decode_attention`` (a split-K kernel over chunks of pages, then
   a merge) against its plain version in float32 and bf16 at Granite
   shapes, with lengths on the split plan's chunk boundaries (0, 1, one
   page, one chunk, one chunk + 1 token, a partial last page in the last
   chunk, the full MAXP), on a batch the plan does not split, and at the
   smoke config's narrow heads (-1 tails, scrambled unreferenced pages;
   within 2e-5, plus one bf16 rounding step in bf16); nvcc's register,
   shared-memory and spill report of its kernels; timed in bf16 at the
   served batch (B = 8, ~1 k tokens), at decode_32k's batch at 4096
   tokens and at one 32 k context beside its plain version, SDPA with
   the gather of each sequence's pages (a yardstick the port never
   calls) and the bytes bound; then a float32 Granite cut to 4
   layers whose ``ServeEngine`` tokens must equal the dense decode's; the
   36-layer bf16 model (weights drawn on the card from the seed) serving
   16 requests with 8 live lanes, the index held to the pager's mapping
   after every applied batch and every request's logits to the
   teacher-forced dense decode within 5 % of the largest |logit|, with
   at least 90 % of the argmaxes equal; three more steps timed, then
   three traced with ``torch.profiler`` (device time by kind and the idle
   share of those steps' wall time); and the churn trace under deferred maintenance with a
   mid-trace ``scan`` checked against the block tables.
6. The DeltaForest at ``benchmarks/forest_scale.py --full`` size
   (``backend_kwargs("forest", ...)``): 500,000 draws in [1, 2,000,000)
   (~442 k keys), height 7, buf_cap 32, per-shard ``max_dnodes``
   8 (n + 50,000) / S / 64.  6.1: for S = 1, 4, 8 (set mode) and S = 4
   (map mode, ``payload_bits=12``) the same read batches (1021 keys:
   shard boundaries, keys above the last live key, below the domain;
   scans of 509 sparse and dense bands at ``max_out`` 128;
   ``successor_k(16)``) through ``make_index("forest",
   engine="lockstep")`` (the fused frontier), the same with
   ``fused=False`` (the dense per-shard dispatch) and the oracle, equal
   bit for bit; after each of 3 update batches (both dispatches' arenas
   equal); under ``deferred`` after clustered inserts that leave items
   buffered in several shards; then ``flush``, every shard's
   ``alloc_fail`` and the live set.  6.2: forest_scale's grid, S in 1, 2,
   4, 8 x batch 256, 1024, 4096, 100,000 ops at 5 % updates (two warm-up
   steps off the clock), under both dispatches beside the ``deltatree``
   baseline (lockstep engine), every step checked against the oracle;
   ops/s, ``speedup``, ``speedup_vs_vmap``, search / update medians, walk
   launches a search batch (1 fused, S dense), view-cache builds / hits.
   6.3: kernels 2 and 3 on the fused views of S = 1 and 8 (K = 1024 keys
   in batch order; 512 dense bands tiled over the shards), exact against
   the plain versions, timed beside the byte bound and the share of lanes
   whose root is the one their block staged.  6.4: phase 5.2's float32
   leg over ``ShardedPagerConfig(num_shards=4)``: tokens equal the dense
   decode's, block tables the single-tree pager's at every step, and the
   fused view reused (``view_hits`` > 0).
7. The paper's comparison structures and the read-path accounting.
   7.1: ``benchmarks/table1_transfers.py --full`` (1,048,576 draws in
   [1, 5,000,000), 500 queries): ``deltatree`` (height 7, ``max_dnodes``
   1 << 17, buf_cap 16), ``static_veb``, ``pointer_bst``,
   ``sorted_array`` and the ΔTree UB=N (height ceil(log2 n) + 2, 4
   ΔNodes; the walk kernels take heights 1-12, so a lockstep read on it
   must raise): mean elements touched and distinct 16- / 128-element
   blocks a search (the host touch model), the ordering static_veb <
   sorted_array < pointer_bst at both; on the deltatree row
   ``obs.transfers.compare_model`` replays on the card (ratio 1.0 exactly
   at B = 8, 16, 32, 64), and a ``collect_stats`` + ``collect_transfers``
   search through kernel 2 must equal a plain read and ``measure``;
   ``fit_log_b`` on the card, r2 >= 0.98.  7.2: ``fig12_big_tree.py``'s
   backends on the phase-3 keys at batch 1024, 0 % and 10 % updates,
   30,000 ops (run_index's stream: two warm-up steps, the baselines' 64
   update rows a step), static_veb at 0 % only, every step against the
   oracle: ops/s, search and update medians beside ``deltatree``
   (lockstep), which runs with ``collect_stats`` as run_index turns it on
   and without, as phase 3 runs it.  Cut: rates 1 / 20 / 100 and batch 256 are not run.  7.3:
   three Fig. 12 steps of the ΔTree (search, eager update) traced with
   ``repro_torch.obs.trace.capture``: device busy and wall time a step and
   the idle share.  7.4: an S = 4 forest at phase 6's size collecting
   stats, fused and dense ``ReadStats`` equal, router lanes summing to the
   batch; phase 5.2's float32 leg over ``ShardedPagerConfig(num_shards=4)``
   whose index collects stats (tokens equal to a stats-free run),
   ``ServeScheduler.metrics()`` in dict, Prometheus and JSON form with the
   search, router and transfers groups.
Each run of a path (fused steps, per-round steps, scans, deferred,
budgeted, each serve run, each forest run, 6.1's fused reads and dense
reads apart, each phase 7 run) sets the launch counters to 0 just before
it and reads them just after: its kernels must have launched (the paged
kernel once per layer per decode step), and no plain version may have
run.

The second-to-last line is ``{"kernels": [...]}`` (rows 2-4 also carry
``forest_launches``: kernel 2's in phase 6.2's fused runs, kernel 3's in
6.1's fused reads, kernel 4's in 6.4's sharded serve run; rows 2 and 4
``phase7_launches``); the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

KEY_MAX = 5_000_000        # benchmarks/fig12_big_tree.py
INITIAL = 2_500_000
TOTAL_OPS = 30_000         # fig12 run() default; sizes the arena
BATCH = 1024               # Fig. 12 concurrency
CHECK_K = 2 ** 16          # queries for the kernel-vs-plain comparison
TIMED_K = (BATCH, 2 ** 20)  # batches the kernels are timed at
UPDATE_PCT = 10
STEPS = 20                 # fused main-path steps
PER_ROUND_STEPS = 3        # main-path steps with walk_fused=False
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SCAN_K = 512               # benchmarks/scan_sweep.py --full batch
SCAN_CHECK_K = 2 ** 12     # lanes for the scan kernel-vs-plain comparison
SCAN_MAX_OUT = (16, 128)   # scan_sweep.py --full k_list
DENSITY_FILL = {"sparse": 0.25, "dense": 4.0}   # scan_sweep.py
TRUNCATING_ROUNDS = 300    # scan round caps below a dense lane's need: this
                           # and TRUNCATING_ROUNDS + 1, so cuts land in both
                           # pass kinds
DEEP_KEYS = 600            # ascending inserts of the deep-path scan check
# The scan kernel's times in the timed cells before its redesign (one
# thread a lane, every pass walked from the root; NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside each cell's time now
SIMPLE_SCAN_MS = {
    ("set int32", "sparse", 16): 0.1322, ("set int32", "sparse", 128): 0.6650,
    ("set int32", "dense", 16): 0.3028, ("set int32", "dense", 128): 2.1023,
    ("map int64", "sparse", 16): 0.1604, ("map int64", "sparse", 128): 0.8184,
    ("map int64", "dense", 16): 0.3461, ("map int64", "dense", 128): 2.6014,
}
# The walk kernels' times before their redesign (one thread a query reading
# router by router, 256 threads a block; set mode, NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside each timed cell now
SIMPLE_WALK_MS = {
    ("fused", "set int32", BATCH): 0.021296,
    ("rows", "set int32", BATCH): 0.009696,
    ("fused", "set int32", 2 ** 20): 0.1136,
}
WALK_CHECK_HEIGHTS = (3, 4, 5, 8, 12)   # besides Fig. 12's 7
WALK_CHECK_K = (1, 31, 33, 1000, 4096)  # part-full blocks at every block size
DEFERRED_STEPS = 10
BUDGETED_STEPS = 3
CSRC = "src/repro_torch/kernels/csrc"
SOURCE = f"{CSRC}/veb_walk.cu"
SCAN_SOURCE = f"{CSRC}/veb_scan.cu"
PA_SOURCE = f"{CSRC}/paged_attention.cu"
# phase 5: the serve path at Granite-8B width (src/repro/configs/granite_8b.py)
PA_TOL = 2e-5    # kernel vs plain in float32, max abs (`paged_err`)
PA_CHECK_B, PA_CHECK_MAX = 8, 2048   # check batch, lengths drawn in 1..2048
PA_SERVED = (8, 1024)                # timed: the served batch, ~1 k tokens
PA_LONG = (64, 4096)                 # timed: decode_32k's batch, shorter
PA_ONE_LONG = (1, 32768)             # timed: one 32 k context
PA_NARROW = (4, 2, 16, 4)            # (QH, KVH, D, PS) of the smoke config
EXACT_LAYERS = 4                     # the float32 exact-token leg's depth
EXACT_REQUESTS, EXACT_PROMPT, EXACT_NEW = 4, (16, 256), 8
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, SERVE_LIVE = 16, (128, 1024), 32, 8
TRACED_STEPS = 3     # full-width scheduler steps traced with torch.profiler
CHURN_STEPS, CHURN_SPLIT, CHURN_HIGH_WATER = 24, 12, 16
# bf16 logits of the paged path vs the dense decode at the same weights,
# as a share of the request's largest |logit|: activations round to 8 bits
# after every product, and the two attention paths round their outputs at
# different points, so 36 residual layers drift (read on the H100: at most
# 0.111 against 6.06 in the served run, 0.102 in the churn run)
LOGIT_REL_TOL_BF16 = 0.05
# share of teacher-forced decode steps whose argmax equals the dense
# decode's (read on the H100: 0.974 served, 0.957 churn)
TOKEN_MATCH_MIN_BF16 = 0.9


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def mixed_kinds(rng, k: int, update_pct: float):
    """benchmarks/common.py::mixed_kinds: half inserts, half deletes."""
    import numpy as np

    u = rng.random(k) < (update_pct / 100.0)
    ins = rng.random(k) < 0.5
    return np.where(u, np.where(ins, 1, 2), 0).astype(np.int32)


def fig12_config(n_keys: int, total_ops: int = TOTAL_OPS) -> dict:
    """benchmarks/common.py::backend_kwargs("deltatree", ...)."""
    n_eff = n_keys + total_ops // 2
    height = 7
    return dict(height=height, buf_cap=32, max_rounds=256,
                max_dnodes=max(256, int(6 * n_eff / 2 ** (height - 1))))


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------


def cuda_ms(fn, reps: int, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events).  A
    sleep kernel ahead of the start event keeps the host's launch work out
    of the window; ``flush`` (a large tensor) is overwritten before each run
    so the walk finds the 50 MB L2 cold, as the main path does."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def walk_threads() -> int:
    """kThreads in csrc/veb_walk.cu: the lanes of a block, which share the
    staged root ΔNode."""
    m = re.search(r"constexpr int kThreads = (\d+);",
                  (ROOT / SOURCE).read_text())
    check(m is not None, "kThreads not found in veb_walk.cu")
    return int(m.group(1))


def piece_count(height: int) -> int:
    """The vEB pieces a path crosses in a height-``height`` ΔNode
    (``veb::piece_plan``): 1 for H <= 4, 2 for 5..8, 3 for 9, 4 above."""
    if height <= 4:
        return 1
    return piece_count(height // 2) + piece_count(height - height // 2)


def fused_needs(t, height: int, q, roots, max_rounds: int):
    """Bytes the fused walk needs on these inputs: every
    distinct (ΔNode, slot) router and child id its lanes read, each once,
    plus queries, roots, outputs and the position table.  A replay of the
    blind descent that records addresses.  Also counts the dependent
    loads from device memory each lane's rounds make: the earlier design
    read router by router (H a round, one more for the child id); this
    one reads a piece at a time (`piece_count` a round, the child ids
    with the last piece) and nothing from the root its block staged.
    Returns (bytes, {"old": per-lane loads, "new": per-lane loads})."""
    import torch

    from repro_torch.kernels.ref import pos_table, walk_big

    pos = pos_table(height, q.device).long()
    m, ub = t.value.shape
    lc = t.child.shape[1]
    bottom0 = 2 ** (height - 1)
    vflat = t.value.reshape(-1)
    act = q != walk_big(t.value.dtype)
    dn = roots.long().clone()
    k = q.numel()
    block = walk_threads()
    staged = roots.long()[torch.arange(k, device=q.device) // block * block]
    staged = staged.clamp(0, m - 1)
    old = torch.zeros(k, dtype=torch.long, device=q.device)
    new = torch.zeros_like(old)
    vidx, cidx = [], []
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
            router = vflat[addr]
            lb = torch.where(router != 0, b, lb)
            b = torch.where(b < bottom0, 2 * b + (v >= router).long(), b)
        bottom = lb >= bottom0
        old[lanes] += height + bottom.long()
        new[lanes] += torch.where(d == staged[lanes], 0, piece_count(height))
        caddr = d * lc + (lb - bottom0).clamp(min=0)
        cidx.append(caddr[bottom])
        nxt = torch.where(bottom, t.child.reshape(-1)[caddr].long(), -1)
        dn[lanes] = torch.where(nxt >= 0, nxt, dn[lanes])
        act[lanes] = nxt >= 0
    isz = t.value.element_size()
    distinct_v = torch.unique(torch.cat(vidx)).numel() if vidx else 0
    distinct_c = torch.unique(torch.cat(cidx)).numel() if cidx else 0
    nbytes = (distinct_v * isz + distinct_c * 4 + k * (isz + 4)
              + k * (2 * isz + 3 * 4) + pos.numel() * 4)
    return nbytes, {"old": old, "new": new}


def rows_needs(rows, height: int, q) -> int:
    """Bytes one in-ΔNode descent per lane needs over
    pre-gathered rows: the distinct slots each lane reads (routers, left
    children, leaf), its child id, query and outputs."""
    import torch

    from repro_torch.kernels.ref import pos_table

    pos = pos_table(height, q.device).long()
    k, ubp = rows.shape
    bottom0 = 2 ** (height - 1)
    lane = torch.arange(k, device=q.device)
    b = torch.ones(k, dtype=torch.long, device=q.device)
    idx = []
    for _ in range(height - 1):
        pr, pl = pos[b], pos[(2 * b).clamp(max=2 * bottom0 - 1)]
        idx += [lane * ubp + pr, lane * ubp + pl]
        router = rows[lane, pr]
        internal = (b < bottom0) & (rows[lane, pl] != 0)
        b = torch.where(internal, 2 * b + (q >= router).long(), b)
    idx.append(lane * ubp + pos[b])
    isz = rows.element_size()
    distinct = torch.unique(torch.cat(idx)).numel()
    return (distinct * isz + int((b >= bottom0).sum()) * 4 + k * isz
            + k * (2 * isz + 2 * 4) + pos.numel() * 4)


def scan_needs(t, height: int, roots, starts, his, max_out: int,
               pmask: int, max_rounds: int):
    """Bytes the scan kernel needs on these inputs: every distinct router
    slot, child id and mark its lanes read, each once, plus roots, bounds,
    outputs and the position table.  A replay of the FIND / VERIFY passes
    of `ref_delta_scan_fused` that records addresses; returns (bytes, the
    replay's per-lane emitted counts), the counts for a consistency check."""
    import torch

    from repro_torch.kernels.ref import pos_table, walk_big

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
    vidx, cidx, midx = [], [], []
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
              + pos.numel() * 4)
    return nbytes, n


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def scan_bands(rng, n_keys: int, k: int, density: str, max_out: int,
               key_max: int = KEY_MAX):
    """benchmarks/scan_sweep.py::_scan_row's windows over [1, key_max]:
    ``k`` lanes whose band holds ~``DENSITY_FILL[density] * max_out`` live
    keys; returns (exclusive starts, inclusive his) as int32 numpy
    arrays."""
    import numpy as np

    width = max(1, int(key_max / n_keys * DENSITY_FILL[density] * max_out))
    lo = rng.integers(1, max(2, key_max - width), k)
    return ((lo - 1).astype(np.int32),
            np.minimum(lo + width, key_max).astype(np.int32))


def pack_bands(cfg, starts, his, device):
    """Packed kernel bounds; the reserved ROUTE_LEFT start becomes the
    sentinel (`engine._walk_queries`)."""
    import torch

    from repro_torch.core.layout import ROUTE_LEFT
    from repro_torch.kernels.veb_search import walk_big

    st = torch.as_tensor(starts, device=device)
    sp = cfg.qpack(st)
    sp[st == int(ROUTE_LEFT)] = walk_big(cfg.vdtype)
    return sp.contiguous(), cfg.qpack(torch.as_tensor(his, device=device))


def check_lanes(cfg, t, n_keys: int, rng, device):
    """``SCAN_CHECK_K`` lanes for the scan comparison: sparse and dense
    bands, empty bands (hi <= start), bands past the last key, bands that
    start just below a tombstoned key, sentinel lanes, and per-lane roots
    at live non-root ΔNodes for 1 lane in 8.  Returns (starts, his, roots,
    number of tombstones seen)."""
    import numpy as np
    import torch

    from repro_torch.core.layout import ROUTE_LEFT

    k = SCAN_CHECK_K
    kind = rng.choice(6, k, p=[0.3, 0.3, 0.08, 0.08, 0.2, 0.04])
    st, hi = scan_bands(rng, n_keys, k, "sparse", 16)
    dst, dhi = scan_bands(rng, n_keys, k, "dense", 128)
    st = np.where(kind == 1, dst, st)
    hi = np.where(kind == 1, dhi, hi)
    hi = np.where(kind == 2, st - rng.integers(0, 100, k), hi)
    past = KEY_MAX + rng.integers(0, 1000, k)
    st = np.where(kind == 3, past, st)
    hi = np.where(kind == 3, past + 10_000, hi)
    tomb = cfg.key_of(t.value[t.mark & t.alive[:, None]]).cpu().numpy()
    if tomb.size:
        at = rng.choice(tomb, k)
        st = np.where(kind == 4, at - rng.integers(1, 4, k), st)
        hi = np.where(kind == 4, at + rng.integers(1, 400, k), hi)
    st = np.where(kind == 5, int(ROUTE_LEFT), st).astype(np.int32)
    hi = hi.astype(np.int32)
    alive = torch.nonzero(t.alive)[:, 0].to(torch.int32)
    roots = t.root.expand(k).clone()
    pick = torch.as_tensor(rng.random(k) < 1 / 8, device=device)
    idx = torch.as_tensor(rng.integers(0, alive.numel(), k), device=device)
    roots = torch.where(pick, alive[idx], roots).contiguous()
    return st, hi, roots, int(tomb.size)


def oracle_scan(live, starts, his, max_out: int):
    """The sorted-oracle answer to a scan batch: (keys (K, max_out) int32
    zero-padded past n, n, more) for bands (start, hi]."""
    import numpy as np

    lo = np.searchsorted(live, starts, side="right")
    cnt = np.maximum(np.searchsorted(live, his, side="right") - lo, 0)
    n = np.minimum(cnt, max_out)
    j = np.arange(max_out)[None, :]
    idx = np.minimum(lo[:, None] + j, max(live.size - 1, 0))
    keys = np.where(j < n[:, None], live[idx] if live.size else 0, 0)
    return keys.astype(np.int32), n.astype(np.int32), cnt > max_out


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def card_check() -> tuple[str, str]:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.build import library

    sources = [Path(SOURCE).name, Path(SCAN_SOURCE).name,
               Path(PA_SOURCE).name]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(library, sources))
    log(f"kernels of {', '.join(sources)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    return card, torch.cuda.get_device_name(0)


def churned_tree(keys, payload_bits: int, rng, device):
    """The Fig. 12 tree after three update batches (marks, grown leaves,
    expanded children; eager maintenance leaves every buffer drained)."""
    import numpy as np

    from repro_torch.core import deltatree as DT

    cfg = DT.TreeConfig(engine="lockstep", payload_bits=payload_bits,
                        **fig12_config(keys.size))
    pays = (keys % 4096).astype(np.int32) if payload_bits else None
    t = DT.bulk_build(cfg, keys, pays, device=device)
    for _ in range(3):
        kinds = mixed_kinds(rng, BATCH, 50)
        qk = rng.integers(1, KEY_MAX, BATCH).astype(np.int32)
        t, _, _ = DT.update_batch(cfg, t, kinds, qk, qk % 4096)
    return cfg, t


def kernel_queries(cfg, t, keys, k: int, rng, device):
    """k packed queries: half present keys, the rest absent or above every
    live key, 1/64 walk sentinels."""
    import numpy as np
    import torch

    from repro_torch.kernels.veb_search import walk_big

    q = rng.integers(1, KEY_MAX + 100_000, k).astype(np.int32)
    half = rng.random(k) < 0.5
    q[half] = rng.choice(keys, int(half.sum()))
    qp = cfg.qpack(torch.as_tensor(q, device=device))
    qp[torch.as_tensor(rng.random(k) < 1 / 64, device=device)] = \
        walk_big(cfg.vdtype)
    return qp


def check_rows_rounds(t, roots, q, height: int, max_rounds: int, where: str):
    """Replays the per-round walk (`repro_torch.kernels.ops._delta_walk`)
    and holds `veb_walk_rows` against its plain version in every round, on
    the rows that walk gathers: each lane's current ΔNode row and child
    row.  Returns the rounds run, the largest difference seen and the
    first round's inputs."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS

    m = t.value.shape[0]
    dn = roots.clone()
    resolved = q == VS.walk_big(t.value.dtype)
    first = None
    rounds = err = 0
    while rounds < max_rounds and not bool(resolved.all()):
        dnc = dn.clamp(0, m - 1).long()
        rws, crw = t.value[dnc], t.child[dnc]
        got = VS.veb_walk_rows(rws, crw, q, height=height)
        want = ref.ref_veb_walk_rows(rws, crw, q, height=height)
        err = max(err, *(int((a.long() - b.long()).abs().max())
                         for a, b in zip(got, want)))
        check(err == 0, f"veb_walk_rows != plain ({where}, round {rounds})")
        if first is None:
            first = (rws, crw)
        nxt = got[2]
        act = ~resolved
        dn = torch.where(act & (nxt >= 0), nxt, dn)
        resolved = resolved | (act & (nxt < 0))
        rounds += 1
    return rounds, err, first


def compare_scan(cfg, t, n_keys: int, sorted_keys, rng, device, flush,
                 mode: str) -> dict:
    """Phase 2 for `veb_scan_fused` on one churned tree: the comparison
    over `check_lanes`, then the timed K = 512 cells.  Returns the largest
    difference and the timed rows."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS
    from repro_torch.kernels.ops import scan_round_cap

    h = cfg.height
    st, hi, roots, n_tomb = check_lanes(cfg, t, n_keys, rng, device)
    sp, hp = pack_bands(cfg, st, hi, device)
    err = 0
    for max_out, cap in ((16, None), (128, None), (128, TRUNCATING_ROUNDS),
                         (128, TRUNCATING_ROUNDS + 1)):
        cap = cap or scan_round_cap(h, cfg.max_dnodes, max_out)
        args = (t.value, t.mark, t.child, roots, sp, hp)
        kw = dict(height=h, max_out=max_out, pmask=cfg.pmask, max_rounds=cap)
        got = VS.veb_scan_fused(*args, **kw)
        want = ref.ref_delta_scan_fused(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, *(int((a.long() - b.long()).abs().max())
                         for a, b in zip(got, want)))
        check(err == 0, f"veb_scan_fused != plain ({mode}, max_out "
                        f"{max_out}, cap {cap})")
        log(f"{mode}: veb_scan_fused equals its plain version on "
            f"{SCAN_CHECK_K} lanes, max_out {max_out}, cap {cap}: emitted "
            f"{int(got[1].sum())}, rows full {int(got[3].sum())}, lanes at "
            f"the cap {int((got[2] == cap).sum())}, max hops "
            f"{int(got[2].max())}, {n_tomb} tombstones in the tree")
    rows = []
    for density in DENSITY_FILL:
        for max_out in SCAN_MAX_OUT:
            st, hi = scan_bands(rng, n_keys, SCAN_K, density, max_out)
            sp, hp = pack_bands(cfg, st, hi, device)
            roots = t.root.expand(SCAN_K).contiguous()
            cap = scan_round_cap(h, cfg.max_dnodes, max_out)
            args = (t.value, t.mark, t.child, roots, sp, hp)
            kw = dict(height=h, max_out=max_out, pmask=cfg.pmask,
                      max_rounds=cap)

            def kern():
                return VS.veb_scan_fused(*args, **kw)

            def plain():
                return ref.ref_delta_scan_fused(*args, **kw)

            stk = torch.as_tensor(st, device=device)
            hik = torch.as_tensor(hi, device=device)
            span = torch.arange(max_out, device=device)

            def yardstick():
                i = torch.searchsorted(sorted_keys, stk, right=True)
                w = (i[:, None] + span).clamp(max=sorted_keys.numel() - 1)
                r = sorted_keys[w]
                return torch.where(r <= hik[:, None], r, 0)

            got, want = kern(), plain()
            torch.cuda.synchronize()
            e = max(int((a.long() - b.long()).abs().max())
                    for a, b in zip(got, want))
            err = max(err, e)
            check(e == 0, f"veb_scan_fused != plain ({mode}, {density}, "
                          f"max_out {max_out}, K={SCAN_K})")
            nbytes, n_replay = scan_needs(t, h, roots, sp, hp, max_out,
                                          cfg.pmask, cap)
            check(torch.equal(n_replay, got[1]), "scan byte replay diverged")
            r = dict(mode=mode, density=density, max_out=max_out, K=SCAN_K,
                     ms=cuda_ms(kern, 10, flush),
                     simple_ms=SIMPLE_SCAN_MS[(mode, density, max_out)],
                     plain_ms=cuda_ms(plain, 2, flush), bytes=nbytes,
                     bound_ms=bound_ms(nbytes), err=e,
                     searchsorted_ms=cuda_ms(yardstick, 10, flush),
                     emitted=int(got[1].sum()), rows_full=int(got[3].sum()),
                     mean_hops=float(got[2].float().mean()))
            log(json.dumps({"table": "veb_scan_fused", **r}))
            rows.append(r)
    return dict(err=err, rows=rows)


def deep_scan_check(payload_bits: int, device) -> int:
    """Phase 2, the scan kernel on paths deeper than its path stack (32
    ΔNodes): a height-3 tree after ``DEEP_KEYS`` ascending inserts in
    batches of 50 (each batch hangs below a longer chain of ΔNodes; built
    on the CPU, then moved to the card), 256 lanes with bands among the
    deepest keys, equal to the plain version at the full cap and at caps
    that cut lanes below the stack.  The tree is
    ``tests/_torch_parity.deep_tree``'s, which the CPU model of the
    kernel's loop and the card tests scan too.  Returns the deepest
    path."""
    import numpy as np
    import torch

    from repro_torch.core import deltatree as DT
    from repro_torch.core.layout import KEY_MAX as DOMAIN_MAX
    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS

    cfg = DT.TreeConfig(height=3, max_dnodes=4096, buf_cap=8,
                        payload_bits=payload_bits, engine="lockstep")
    t = DT.bulk_build(cfg, np.arange(1, 5, dtype=np.int32),
                      np.arange(1, 5) if payload_bits else None, device="cpu")
    for s in range(0, DEEP_KEYS, 50):
        keys = np.arange(10 + s, 60 + s, dtype=np.int32)
        t, _, _ = DT.update_batch(cfg, t, np.ones(50, np.int32), keys,
                                  keys % 97)
    dels = np.arange(DEEP_KEYS - 30, DEEP_KEYS + 10, 3, dtype=np.int32)
    t, _, _ = DT.update_batch(cfg, t, np.full(dels.size, 2, np.int32), dels)
    t = DT.from_numpy(cfg, DT.to_numpy(t), device)
    rng = np.random.default_rng(payload_bits)
    k = 256
    st = rng.integers(DEEP_KEYS - 40, DEEP_KEYS, k).astype(np.int32)
    hi = (st + rng.integers(5, 80, k)).astype(np.int32)
    st[0], hi[0] = 0, DOMAIN_MAX
    sp = cfg.qpack(torch.as_tensor(st, device=device)).contiguous()
    hp = cfg.qpack(torch.as_tensor(hi, device=device)).contiguous()
    roots = t.root.expand(k).contiguous()
    depth = ref.ref_delta_walk_fused(t.value, t.child, roots, sp, height=3,
                                     max_rounds=10_000)[3]
    check(int(depth[1:].min()) > 32, "the deep-path check's paths fit the "
                                     "path stack")
    for cap in (10_000, 37, 501, 1000):
        args = (t.value, t.mark, t.child, roots, sp, hp)
        kw = dict(height=3, max_out=16, pmask=cfg.pmask, max_rounds=cap)
        got = VS.veb_scan_fused(*args, **kw)
        want = ref.ref_delta_scan_fused(*args, **kw)
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        check(err == 0, f"veb_scan_fused != plain on deep paths (payload "
                        f"bits {payload_bits}, cap {cap})")
        log(f"deep paths (height 3, payload bits {payload_bits}): "
            f"veb_scan_fused equals its plain version on {k} lanes, cap "
            f"{cap}: paths {int(depth.min())}-{int(depth.max())} ΔNodes, "
            f"emitted {int(got[1].sum())}, lanes at the cap "
            f"{int((got[2] == cap).sum())}")
    return int(depth.max())


def walk_height_check(height: int, payload_bits: int, device) -> None:
    """Phase 2, both walk kernels on a small churned tree of another
    height than Fig. 12's (``tests/test_torch_cuda.py``'s tree: 20 k keys,
    two update batches): 4096 queries (present, absent, above every key,
    sentinels), 1 lane in 5 rooted at a live non-root ΔNode; the fused
    kernel equal to its plain version at K = 4096 and at batches that
    leave a block part-full, ``veb_walk_rows`` in every round of the
    per-round walk."""
    import numpy as np
    import torch

    from repro_torch.core import deltatree as DT
    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS

    rng = np.random.default_rng(100 * height + payload_bits)
    vals = np.unique(rng.integers(1, 200_000, 20_000))
    n_eff = vals.size + 1024
    cfg = DT.TreeConfig(height=height, buf_cap=16, engine="lockstep",
                        payload_bits=payload_bits,
                        max_dnodes=max(256, 6 * n_eff // 2 ** (height - 1)))
    t = DT.bulk_build(cfg, vals, vals % 4096 if payload_bits else None,
                      device=device)
    for _ in range(2):
        kinds = rng.choice([1, 2], 512).astype(np.int32)
        keys = rng.integers(1, 200_000, 512).astype(np.int32)
        t, _, _ = DT.update_batch(cfg, t, kinds, keys, keys % 4096)
    check(not bool(t.alloc_fail), f"arena exhausted at height {height}")
    q = kernel_queries(cfg, t, vals, 4096, rng, device)
    alive = torch.nonzero(t.alive)[:, 0].to(torch.int32)
    roots = t.root.expand(q.numel()).clone()
    pick = rng.integers(0, alive.numel(), roots[::5].numel())
    roots[::5] = alive[torch.as_tensor(pick, device=device)]
    cap = cfg.walk_round_cap
    where = f"height {height}, payload bits {payload_bits}"
    for k in WALK_CHECK_K:
        rk, qk = roots[:k].contiguous(), q[:k].contiguous()
        got = VS.veb_walk_fused(t.value, t.child, rk, qk, height=height,
                                max_rounds=cap)
        want = ref.ref_delta_walk_fused(t.value, t.child, rk, qk,
                                        height=height, max_rounds=cap)
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        check(err == 0, f"veb_walk_fused != plain ({where}, K={k})")
        rounds, _, _ = check_rows_rounds(t, rk, qk, height, cap,
                                         f"{where}, K={k}")
    log(f"height {height}, payload bits {payload_bits}: both walk kernels "
        f"equal their plain versions (K = {', '.join(map(str, WALK_CHECK_K))}"
        f"; max hops {int(got[3].max())}, veb_walk_rows in all {rounds} "
        f"rounds)")


def compare_kernels(keys, rng, device, flush) -> dict:
    """Phase 2.  Returns per-kernel rows for the result line (walks timed
    at the main path's batch of 1024, the scan at K = 512) and prints the
    wider timing tables."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS
    from repro_torch.kernels.build import resource_usage

    rows = {}
    scan = []
    sorted_keys = None
    walk_usage = ptxas_lines(resource_usage(Path(SOURCE).name),
                             ("walk_fused_kernel", "walk_rows_kernel"))
    usage = ptxas_lines(resource_usage(Path(SCAN_SOURCE).name),
                        ("scan_fused_kernel",))
    for line in walk_usage + usage:
        log(f"ptxas: {line}")
    for height in WALK_CHECK_HEIGHTS:
        for bits in (0, 12):
            walk_height_check(height, bits, device)
    deep = [deep_scan_check(bits, device) for bits in (0, 12)]
    for bits in (0, 12):
        mode = "map int64" if bits else "set int32"
        cfg, t = churned_tree(keys, bits, rng, device)
        h, cap = cfg.height, cfg.walk_round_cap
        if sorted_keys is None:
            from repro_torch.core import deltatree as DT

            sorted_keys = torch.as_tensor(DT.live_keys(cfg, t), device=device)
        for k in (CHECK_K, *TIMED_K):
            q = kernel_queries(cfg, t, keys, k, rng, device)
            roots = t.root.expand(k).contiguous()

            def fused():
                return VS.veb_walk_fused(t.value, t.child, roots, q,
                                         height=h, max_rounds=cap)

            def plain():
                return ref.ref_delta_walk_fused(t.value, t.child, roots, q,
                                                height=h, max_rounds=cap)

            got, want = fused(), plain()
            torch.cuda.synchronize()
            err = max(int((a.long() - b.long()).abs().max()) for a, b in
                      zip(got, want))
            check(err == 0, f"veb_walk_fused != plain ({mode}, K={k})")
            rounds, rerr, (rws, crw) = check_rows_rounds(
                t, roots, q, h, cap, f"{mode}, K={k}")

            def rows_k():
                return VS.veb_walk_rows(rws, crw, q, height=h)

            def rows_p():
                return ref.ref_veb_walk_rows(rws, crw, q, height=h)

            if k == CHECK_K:
                log(f"{mode}: both kernels equal their plain versions "
                    f"on 2**16 queries (max hops {int(got[3].max())}, "
                    f"veb_walk_rows checked in all {rounds} rounds)")
                continue
            keys_q = cfg.key_of(q).to(torch.int32).contiguous()
            reps = 20 if k == BATCH else 5
            fb, trips = fused_needs(t, h, q, roots, cap)
            rb = rows_needs(rws, h, q)
            res = {
                "fused": dict(ms=cuda_ms(fused, reps, flush),
                              plain_ms=cuda_ms(plain, 3, flush),
                              bytes=fb, err=err, bound_ms=bound_ms(fb),
                              trips_old=float(trips["old"].float().mean()),
                              trips_new=float(trips["new"].float().mean())),
                "rows": dict(ms=cuda_ms(rows_k, reps, flush),
                             plain_ms=cuda_ms(rows_p, 3, flush),
                             bytes=rb, err=rerr, bound_ms=bound_ms(rb),
                             rounds=rounds),
            }
            ss = cuda_ms(lambda: torch.searchsorted(sorted_keys, keys_q),
                         reps, flush)
            for name, r in res.items():
                r["searchsorted_ms"] = ss
                r["simple_ms"] = SIMPLE_WALK_MS.get((name, mode, k))
                log(json.dumps({"table": f"veb_walk_{name}", "mode": mode,
                                "K": k, **r}))
                if k == BATCH and bits == 0:
                    rows[name] = r
        scan.append(compare_scan(cfg, t, keys.size, sorted_keys, rng, device,
                                 flush, mode))
        del t
        torch.cuda.empty_cache()
    # the result line carries the set-mode dense max_out=128 cell (the
    # default page of Index.range_scan); every cell is in the log
    cell = next(r for r in scan[0]["rows"]
                if r["density"] == "dense" and r["max_out"] == 128)
    rows["fused"]["ptxas"] = rows["rows"]["ptxas"] = walk_usage
    rows["scan"] = dict(cell, err=max(x["err"] for x in scan),
                        cells=[r for x in scan for r in x["rows"]],
                        ptxas=usage, deep_paths=deep)
    return rows


def reset_counts() -> None:
    from repro_torch.kernels import delta_paged_attention as PA
    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS

    VS.veb_walk_fused.launches = 0
    VS.veb_walk_rows.launches = 0
    VS.veb_scan_fused.launches = 0
    PA.paged_decode_attention.launches = 0
    ref.ref_delta_walk_fused.calls = 0
    ref.ref_veb_walk_rows.calls = 0
    ref.ref_delta_scan_fused.calls = 0
    ref.ref_paged_decode_attention.calls = 0


def read_counts() -> dict:
    from repro_torch.kernels import delta_paged_attention as PA
    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS

    return dict(fused=VS.veb_walk_fused.launches,
                rows=VS.veb_walk_rows.launches,
                scan=VS.veb_scan_fused.launches,
                paged=PA.paged_decode_attention.launches,
                plain=ref.ref_delta_walk_fused.calls
                + ref.ref_veb_walk_rows.calls
                + ref.ref_delta_scan_fused.calls
                + ref.ref_paged_decode_attention.calls)


def main_path(keys, rng, device, steps: int, walk_fused: bool):
    """Phase 3: Fig. 12's concurrency-1024 mix through the Index API.
    Returns (result row, index, oracle)."""
    import numpy as np
    import torch

    from repro_torch.api import OpBatch, make_index
    from repro_torch.core.oracle import SetOracle

    t0 = time.perf_counter()
    ix = make_index("deltatree", initial=keys, engine="lockstep",
                    device=device, walk_fused=walk_fused,
                    **fig12_config(keys.size))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    arena = sum(x.numel() * x.element_size() for x in ix.state)
    oracle = SetOracle(keys)
    reset_counts()
    search_s, update_s, hops = [], [], []
    for step in range(steps):
        kinds = mixed_kinds(rng, BATCH, UPDATE_PCT)
        qk = rng.integers(1, KEY_MAX, BATCH).astype(np.int32)
        t1 = time.perf_counter()
        found, h = ix.search(qk)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ix, res = ix.insert_delete(OpBatch.mixed(kinds, qk))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        search_s.append(t2 - t1)
        update_s.append(t3 - t2)
        hops.append(float(h.float().mean()))
        check((found.cpu().numpy() == oracle.snapshot_search(qk)).all(),
              f"search results differ from the oracle at step {step}")
        check((res.cpu().numpy() == oracle.apply_updates(kinds, qk)).all(),
              f"update results differ from the oracle at step {step}")
    q = rng.integers(0, KEY_MAX + 1000, BATCH).astype(np.int32)
    q[:8] = np.iinfo(np.int32).max - 1
    sf, sk = ix.successor(q)
    live = oracle.keys()
    idx = np.searchsorted(live, q, side="right")
    want_f = idx < live.size
    want_k = np.where(want_f, live[np.minimum(idx, live.size - 1)], 0)
    check((sf.cpu().numpy() == want_f).all()
          and (sk.cpu().numpy() == want_k).all(),
          "successor results differ from the oracle")
    torch.cuda.synchronize()
    counts = read_counts()
    from repro_torch.core import deltatree as DT

    check((DT.live_keys(ix.cfg, ix.state) == live).all(),
          "live keys differ from the oracle")
    check(not ix.alloc_failed(), "arena allocation failed")
    row = dict(walk_fused=walk_fused, keys=int(keys.size),
               max_dnodes=ix.cfg.max_dnodes, arena_mb=arena / 1e6,
               build_s=build_s, steps=steps, counts=counts,
               search_ms=statistics.median(search_s[1:] or search_s) * 1e3,
               update_ms=statistics.median(update_s[1:] or update_s) * 1e3,
               mean_hops=statistics.fmean(hops), size=ix.size())
    return row, ix, oracle


def timed(fn):
    """(fn's result, host seconds to its end on the card)."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_scan(res, live, starts, his, max_out: int, where: str) -> None:
    """A scan batch's (keys, payloads, n, hops, more) equals the sorted
    oracle on bands (start, hi]."""
    keys, n, more = oracle_scan(live, starts, his, max_out)
    check((res[0].cpu().numpy() == keys).all()
          and (res[2].cpu().numpy() == n).all()
          and (res[4].cpu().numpy() == more).all(),
          f"scan results differ from the oracle ({where})")


def scan_path(ix, oracle, rng) -> dict:
    """Phase 3, range scans on the main path's index: one K = 512 batch
    per (density, max_out) cell, one successor_k batch, three paginated
    range_scans.  Counters set to 0 before, read after."""
    import numpy as np

    from repro_torch.core.layout import KEY_MAX as DOMAIN_MAX

    live = oracle.keys()
    reset_counts()
    batch_ms = {}
    for density in DENSITY_FILL:
        for max_out in SCAN_MAX_OUT:
            st, hi = scan_bands(rng, live.size, SCAN_K, density, max_out)
            res, sec = timed(lambda: ix.spec.backend.scan(
                ix.cfg, ix.state, st, hi, max_out))
            check_scan(res, live, st, hi, max_out, f"{density} {max_out}")
            batch_ms[f"{density}/{max_out}"] = sec * 1e3
    q = rng.integers(0, KEY_MAX + 1000, BATCH).astype(np.int32)
    res, sec = timed(lambda: ix.successor_k(q, 16))
    check_scan(res, live, q, np.full_like(q, DOMAIN_MAX), 16, "successor_k")
    batch_ms["successor_k/16"] = sec * 1e3
    pages, page_ms = 0, []
    for _ in range(3):
        width = int(KEY_MAX / live.size * 1000)
        lo = int(rng.integers(1, KEY_MAX - width))
        hi = lo + width
        got, cursor = [], None
        while True:
            res, sec = timed(lambda: ix.range_scan(lo, hi, cursor=cursor))
            page_ms.append(sec * 1e3)
            got.extend(res.keys.tolist())
            pages += 1
            if res.cursor is None:
                break
            cursor = res.cursor
        want = live[(live >= lo) & (live <= hi)]
        check(got == want.tolist(), "range_scan pages differ from the oracle")
    counts = read_counts()
    check(counts["scan"] > 0, "the scan path did not launch veb_scan_fused")
    check(counts["plain"] == 0, "the scan path ran a plain version")
    return dict(batch_ms=batch_ms, pages=pages,
                page_ms=statistics.median(page_ms), counts=counts)


def relaxed_path(keys, rng, device, policy: str, steps: int) -> dict:
    """Phase 4: the Fig. 12 mix under a relaxed maintenance policy, scans
    and successors checked against the oracle every step, then flush.

    Uniform inserts into ~1.97 M keys almost never meet in one leaf
    position (a few hundred inserts over ~2 M gaps), so the Fig. 12 mix
    alone leaves the overflow buffers empty.  A first batch therefore
    inserts runs of consecutive keys after 128 live keys (time-ordered ids
    do this): the third key of a run and later ones reach an occupied
    bottom leaf and are buffered, and the relaxed policy carries them
    through the steps that follow, where every scan must merge them.
    Counters set to 0 before the batches, read after."""
    import numpy as np
    import torch

    from repro_torch.api import OpBatch, make_index
    from repro_torch.core import deltatree as DT
    from repro_torch.core.oracle import SetOracle

    ix = make_index("deltatree", initial=keys, engine="lockstep",
                    maintenance=policy, device=device,
                    **fig12_config(keys.size))
    torch.cuda.synchronize()
    oracle = SetOracle(keys)
    reset_counts()
    runs = (rng.choice(keys, BATCH // 8)[:, None]
            + np.arange(1, 9)).reshape(-1).astype(np.int32)
    ones = np.ones(runs.size, np.int32)
    (ix, res, stats), clustered_s = timed(lambda: ix.update(
        OpBatch.mixed(ones, runs)))
    check((res.cpu().numpy() == oracle.apply_updates(ones, runs)).all(),
          f"{policy}: clustered insert results differ from the oracle")
    update_s, scan_s, pending, merged = [], [], [stats.pending], []
    for step in range(steps):
        kinds = mixed_kinds(rng, BATCH, UPDATE_PCT)
        qk = rng.integers(1, KEY_MAX, BATCH).astype(np.int32)
        found, _ = ix.search(qk)
        check((found.cpu().numpy() == oracle.snapshot_search(qk)).all(),
              f"{policy}: search differs from the oracle at step {step}")
        (ix, res, stats), sec = timed(lambda: ix.update(
            OpBatch.mixed(kinds, qk)))
        update_s.append(sec)
        pending.append(stats.pending)
        check((res.cpu().numpy() == oracle.apply_updates(kinds, qk)).all(),
              f"{policy}: update results differ at step {step}")
        live = oracle.keys()
        st, hi = scan_bands(rng, live.size, SCAN_K, "dense", 128)
        sres, sec = timed(lambda: ix.spec.backend.scan(
            ix.cfg, ix.state, st, hi, 128))
        scan_s.append(sec)
        check_scan(sres, live, st, hi, 128, f"{policy} step {step}")
        buf = ix.state.buf
        buffered = ix.cfg.key_of(buf[buf != 0]).cpu().numpy()
        merged.append(int(np.isin(sres[0].cpu().numpy(), buffered).sum()))
        q = rng.integers(0, KEY_MAX + 1000, BATCH).astype(np.int32)
        sf, sk = ix.successor(q)
        idx = np.searchsorted(live, q, side="right")
        want_f = idx < live.size
        want_k = np.where(want_f, live[np.minimum(idx, live.size - 1)], 0)
        check((sf.cpu().numpy() == want_f).all()
              and (sk.cpu().numpy() == want_k).all(),
              f"{policy}: successor differs from the oracle at step {step}")
    counts = read_counts()
    check(min(pending) > 0, f"{policy}: a step carried no buffered items")
    check(sum(merged) > 0, f"{policy}: no scan emitted a buffered item")
    check(counts["scan"] >= steps, f"{policy}: veb_scan_fused not launched")
    check(counts["plain"] == 0, f"{policy}: a plain version ran")
    (ix, fstats), flush_s = timed(ix.flush)
    check(fstats.pending == 0, f"{policy}: flush left buffered items")
    check((DT.live_keys(ix.cfg, ix.state) == oracle.keys()).all(),
          f"{policy}: live keys differ from the oracle after flush")
    check(not ix.alloc_failed(), f"{policy}: arena allocation failed")
    return dict(policy=policy, steps=steps, pending=pending, counts=counts,
                merged_items=merged, clustered_ms=clustered_s * 1e3,
                update_ms=statistics.median(update_s) * 1e3,
                scan_ms=statistics.median(scan_s) * 1e3,
                flush_s=flush_s, flush_rounds=fstats.rounds)


# --------------------------------------------------------------------------
# phase 5: the serve path at Granite-8B width
# --------------------------------------------------------------------------


def paged_case(gen, rng, device, dtype, lens, scramble: bool = True,
               spare: int = 64, shape=None):
    """Paged decode inputs at Granite width (QH 32, KVH 8, D 128, PS 16)
    or at ``shape`` = (QH, KVH, D, PS): block tables from a random
    permutation of the pages with -1 tails, ``spare`` unreferenced pages
    (scrambled to +-1e3 when asked), K/V and q drawn on the card.  Returns
    (q, k_pages, v_pages, tables, lens)."""
    import numpy as np
    import torch

    from repro_torch.configs.granite_8b import CONFIG

    qh, kvh, d, ps = shape or (CONFIG.num_heads, CONFIG.num_kv_heads,
                               CONFIG.head_dim, 16)
    b = lens.size
    need = -(-lens // ps)
    maxp = max(int(need.max()), 1)
    offs = np.concatenate([[0], np.cumsum(need)])
    n_pages = int(offs[-1]) + spare
    perm = rng.permutation(n_pages).astype(np.int32)
    bt = np.full((b, maxp), -1, np.int32)
    for i in range(b):
        bt[i, :need[i]] = perm[offs[i]:offs[i + 1]]

    def draw(shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(dtype)

    kp = draw((n_pages, ps, kvh, d))
    vp = draw((n_pages, ps, kvh, d))
    if scramble:
        unused = torch.as_tensor(perm[offs[-1]:].astype(np.int64),
                                 device=device)
        kp[unused] = 1e3
        vp[unused] = -1e3
    q = draw((b, qh, d))
    return (q, kp, vp, torch.as_tensor(bt, device=device),
            torch.as_tensor(lens.astype(np.int32), device=device))


def paged_err(got, want) -> tuple[float, bool]:
    """Max abs error of the paged kernel against its plain version, and
    whether every element is in tolerance: within ``PA_TOL`` (the float32
    sums' other order); in bfloat16 within ``PA_TOL`` plus one bf16
    rounding step at the element's magnitude (2^(e-7) for |want| in
    [2^e, 2^(e+1))), since both round an f32 result and may land on either
    side of a rounding boundary."""
    import torch

    err = (got.float() - want.float()).abs()
    tol = torch.full_like(err, PA_TOL)
    if got.dtype == torch.bfloat16:
        mag = want.float().abs().clamp(min=2.0 ** -126)
        tol = tol + torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(err.max()), bool((err <= tol).all())


def paged_bytes(q, kp, bt, lens) -> int:
    """Bytes paged decode attention must move: every K and V page below
    ceil(seq_len / PS) once, q and the output, tables and lengths."""
    ps, kvh, d = kp.shape[1], kp.shape[2], kp.shape[3]
    pages = int(((lens.long() + ps - 1) // ps).clamp(max=bt.shape[1]).sum())
    elt = kp.element_size()
    return (2 * pages * ps * kvh * d * elt + 2 * q.numel() * elt
            + bt.numel() * 4 + lens.numel() * 4)


def sdpa_paged(q, kp, vp, bt, lens):
    """The library yardstick (never called by the port): gather each
    sequence's pages into a contiguous cache, then one
    ``scaled_dot_product_attention`` with the length mask."""
    import torch
    import torch.nn.functional as F

    b, qh, d = q.shape
    ps, kvh = kp.shape[1], kp.shape[2]
    maxp = bt.shape[1]
    idx = bt.clamp(min=0).long()
    k = kp[idx].reshape(b, maxp * ps, kvh, d).transpose(1, 2)
    v = vp[idx].reshape(b, maxp * ps, kvh, d).transpose(1, 2)
    mask = (torch.arange(maxp * ps, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    out = F.scaled_dot_product_attention(q[:, :, None, :], k, v,
                                         attn_mask=mask, enable_gqa=True)
    return out[:, :, 0]


def paged_check_cases(rng, sms: int) -> list:
    """(name, shape or None for Granite, lengths) of the kernel-vs-plain
    check: lengths on the split plan's boundaries at Granite width (0, 1,
    one page, exactly one chunk, one chunk + 1 token, a partial last page
    inside the last chunk, the longest at full MAXP, one drawn), a batch
    short enough that the plan does not split, and the smoke config's
    narrow heads with their own chunk boundaries."""
    import numpy as np

    from repro_torch.kernels.delta_paged_attention import split_plan

    ps = 16
    splits, pps = split_plan(PA_CHECK_B, 8, PA_CHECK_MAX // ps, sms)
    check(splits > 1, f"the check batch does not split ({splits})")
    chunk = pps * ps
    split = np.array([0, 1, ps, chunk, chunk + 1, PA_CHECK_MAX - 7,
                      PA_CHECK_MAX, rng.integers(1, PA_CHECK_MAX + 1)])
    unsplit = np.array([0, 1, ps, ps + 1, 100, 128,
                        *rng.integers(1, 129, 2)])
    check(split_plan(PA_CHECK_B, 8, 128 // ps, sms)[0] == 1,
          "the short batch splits")
    nps = PA_NARROW[3]
    nplan = split_plan(PA_CHECK_B, PA_NARROW[1], 64 // nps, sms)
    nchunk = nplan[1] * nps
    narrow = np.array([0, 1, nps, nchunk, nchunk + 1, 61, 64,
                       rng.integers(1, 65)])
    return [("split", None, split), ("unsplit", None, unsplit),
            ("narrow", PA_NARROW, narrow)]


def compare_paged(rng, device, seed: int) -> dict:
    """Phase 5.1: the paged kernel against its plain version in float32
    and bfloat16 on the split-boundary, unsplit and narrow cases
    (`paged_check_cases`; -1 tails, scrambled unreferenced pages), then
    timed in bfloat16 at the served batch, decode_32k's batch and one
    32 k context beside the plain version, the SDPA yardstick and the
    bytes bound.  Also keeps nvcc's register / shared-memory / spill
    report of the kernel's source."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.build import resource_usage
    from repro_torch.kernels.delta_paged_attention import (
        paged_decode_attention,
        split_plan,
    )

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    usage = resource_usage(Path(PA_SOURCE).name)
    for line in ptxas_lines(usage):
        log(f"ptxas: {line}")
    gen = torch.Generator(device=device).manual_seed(seed)
    errs = {}
    for case, shape, lens in paged_check_cases(rng, sms):
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            args = paged_case(gen, rng, device, dtype, lens, shape=shape)
            got = paged_decode_attention(*args)
            want = ref.ref_paged_decode_attention(*args)
            torch.cuda.synchronize()
            err, ok = paged_err(got, want)
            where = f"{case}, {name}"
            check(bool(torch.isfinite(got).all()), f"paged kernel: non-finite "
                                                   f"output ({where})")
            check(bool((got[0] == 0).all()), f"paged kernel: length 0 is not "
                                             f"0 ({where})")
            check(ok, f"paged kernel != plain ({where}): max abs err {err}")
            plan = split_plan(lens.size, args[1].shape[2], args[3].shape[1],
                              sms)
            log(f"paged_decode_attention equals its plain version ({where}, "
                f"plan {plan}): max abs err {err} (tolerance {PA_TOL}"
                f"{' + one bf16 rounding step' if name == 'bfloat16' else ''}"
                f"), largest |out| {float(want.float().abs().max())}, "
                f"lengths {lens.tolist()}")
            errs[f"{case}/{name}"] = err
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
    rows = []
    for b, tokens in (PA_SERVED, PA_LONG, PA_ONE_LONG):
        lens = np.full(b, tokens)
        if b == PA_SERVED[0]:    # the served batch: lengths around 1 k
            lens = rng.integers(tokens // 2, 3 * tokens // 2 + 1, b)
        args = paged_case(gen, rng, device, torch.bfloat16, lens,
                          scramble=False)
        got = paged_decode_attention(*args)
        lib = sdpa_paged(*args)
        want = ref.ref_paged_decode_attention(*args)
        torch.cuda.synchronize()
        nbytes = paged_bytes(args[0], args[1], args[3], args[4])
        r = dict(B=b, tokens=int(lens.sum()), max_len=int(lens.max()),
                 dtype="bfloat16",
                 plan=split_plan(b, args[1].shape[2], args[3].shape[1], sms),
                 ms=cuda_ms(lambda: paged_decode_attention(*args), 20, flush),
                 plain_ms=cuda_ms(lambda: ref.ref_paged_decode_attention(
                     *args), 3, flush),
                 library_ms=cuda_ms(lambda: sdpa_paged(*args), 10, flush),
                 bytes=nbytes, bound_ms=bound_ms(nbytes),
                 err=paged_err(got, want)[0],
                 library_err=float((lib.float() - want.float()).abs().max()))
        check(paged_err(got, want)[1], f"paged kernel != plain at B={b}: "
                                       f"{r['err']}")
        log(json.dumps({"table": "paged_decode_attention", **r}))
        rows.append(r)
        del args, got, lib, want
        torch.cuda.empty_cache()
    return dict(rows[0], max_abs_err=max(errs.values()), errs=errs,
                cells=rows, ptxas=usage)


# the instantiations of csrc/paged_attention.cu the Granite serve path runs
# (bf16 and float32 at D = 128, G = 4: 16 and 32 lanes a row) and the merge
PAGED_PTXAS = ("13__nv_bfloat16Li16ELi4E", "fLi32ELi4E",
               "paged_decode_merge_kernel")


def ptxas_lines(usage: str, keep=PAGED_PTXAS) -> list:
    """The lines of nvcc's ``-Xptxas -v`` report for the entries whose
    mangled names hold one of ``keep``: each entry's name, then its
    registers, shared memory and spill lines."""
    out, on = [], False
    for line in usage.splitlines():
        if "Compiling entry function" in line:
            on = any(k in line for k in keep)
        if on and ("Compiling entry" in line or "Used" in line
                   or "spill" in line):
            out.append(line.strip())
    return out


# the paged decode attention's two kernels (csrc/paged_attention.cu)
PAGED_KERNELS = ("paged_decode_split_kernel", "paged_decode_merge_kernel")


def device_split(prof, steps: int) -> dict:
    """Device time (ms) a step of a trace over ``steps`` scheduler steps,
    by kind: the paged kernels (the split-K pass and the merge), the matrix
    products, everything else, and their sum (one stream, so the sum is
    the device's busy time)."""
    import torch

    out = {"paged": 0.0, "matmul": 0.0, "other": 0.0}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.name
        kind = ("paged" if any(k in name for k in PAGED_KERNELS) else
                "matmul" if any(k in name for k in ("nvjet", "gemm", "splitK",
                                                     "cutlass", "xmma"))
                else "other")
        out[kind] += evt.time_range.elapsed_us() / 1e3 / steps
    out["busy"] = out["paged"] + out["matmul"] + out["other"]
    return out


def trace_steps(model, rng) -> dict:
    """A separate short serve run at full width, so the trace costs the
    measured runs nothing: 8 requests admitted and prefilled, one step to
    warm up, ``TRACED_STEPS`` scheduler steps of 8 live lanes timed without
    the profiler, then ``TRACED_STEPS`` more under ``torch.profiler``.
    Returns the traced steps' device time a step by kind, their host wall
    time a step (``step_ms``, a whole scheduler step: growth, lookups,
    decode, tokens, staged updates), the idle share over that same span,
    and the untraced steps' wall time a step (what the profiler costs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import PagerConfig, ServeEngine

    cfg = model.cfg
    eng = ServeEngine(cfg, model, PagerConfig(engine="lockstep"),
                      max_batch=SERVE_LIVE)
    for n in rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_LIVE):
        eng.submit(rng.integers(1, cfg.vocab_size, int(n)).astype("int32"),
                   max_new=SERVE_NEW)
    eng.step()      # admits and prefills every request, decodes once
    eng.step()

    def steps() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRACED_STEPS):
            check(len(eng.step()) == SERVE_LIVE, "trace: a lane finished")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / TRACED_STEPS

    untraced_ms = steps()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_ms = steps()
    del eng
    torch.cuda.empty_cache()
    out = device_split(prof, TRACED_STEPS)
    # not measured when the trace holds no device event
    idle = 1 - out["busy"] / step_ms if out["busy"] > 0 else None
    return dict(out, step_ms=step_ms, untraced_step_ms=untraced_ms,
                idle_share=idle)


class Probe:
    """Instruments one serve run from the outside: wraps the scheduler's
    decode (host time to the step's tokens, lanes), the pager's
    block-table lookup (host time, synchronized), the paged kernel (CUDA
    events per launch), the prefill (host time) and the decode step's
    logits (kept per request on the card, for the dense comparison).
    ``check_index`` holds the index's live items against the pager's
    mapping after every applied batch."""

    def __init__(self, eng, check_index: bool):
        import torch

        from repro_torch.serve import decode as D

        self.eng, self.D = eng, D
        self.decode_s, self.lookup_s, self.prefill_s = [], [], []
        self.kernel_ms, self.lanes, self.index_checks = [], [], 0
        self.logits: dict[int, list] = {}
        self._events = []
        self._orig = (D.paged_decode_attention, D.paged_decode_step,
                      D.prefill_to_pages)
        kern, step, prefill = self._orig

        def timed_kernel(*a):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = kern(*a)
            e.record()
            self._events.append((s, e))
            return out

        def capture_step(*a, **k):
            out = step(*a, **k)
            self._last_logits = out[0][:, 0]
            return out

        def timed_prefill(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = prefill(*a, **k)
            torch.cuda.synchronize()
            self.prefill_s.append(time.perf_counter() - t0)
            return out

        D.paged_decode_attention = timed_kernel
        D.paged_decode_step = capture_step
        D.prefill_to_pages = timed_prefill
        decode = eng._decode

        def timed_decode(sids):
            t0 = time.perf_counter()
            toks = decode(sids)                 # ends in the tokens' sync
            self.decode_s.append(time.perf_counter() - t0)
            self.lanes.append(len(sids))
            self.kernel_ms.append(sum(s.elapsed_time(e)
                                      for s, e in self._events))
            self._events.clear()
            for bi, sid in enumerate(sids):
                self.logits.setdefault(sid, []).append(
                    self._last_logits[bi].clone())
            return toks

        eng._decode = timed_decode
        pg = eng.pager
        lookup = pg.block_tables

        def timed_lookup(sids, n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = lookup(sids, n)
            torch.cuda.synchronize()
            self.lookup_s.append(time.perf_counter() - t0)
            return out

        pg.block_tables = timed_lookup
        if check_index:
            apply = pg.apply_staged

            def checked_apply(*a, **k):
                out = apply(*a, **k)
                self.check_mapping()
                return out

            pg.apply_staged = checked_apply

    def check_mapping(self) -> None:
        """The index's live (key, page) items equal the pager's mapping:
        every allocated block of every sequence, once all staged ops are
        applied."""
        pg = self.eng.pager
        want = sorted(
            (int(k), int(p)) for sid, n in pg.seq_blocks.items()
            for k, p in zip(pg._key(sid, range(n)), pg._staged_pages[sid]))
        check(pg.index.live_items() == want,
              "the pager's index differs from its mapping")
        self.index_checks += 1

    def close(self) -> None:
        D = self.D
        (D.paged_decode_attention, D.paged_decode_step,
         D.prefill_to_pages) = self._orig

    def summary(self) -> dict:
        from repro_torch.api.index import cfg_attr

        return dict(
            decode_steps=len(self.lanes),
            decode_step_ms=statistics.median(self.decode_s) * 1e3,
            lookup_ms=statistics.median(self.lookup_s) * 1e3,
            kernel_ms_per_step=statistics.median(self.kernel_ms),
            prefill_ms=statistics.median(self.prefill_s) * 1e3,
            prefills=len(self.prefill_s),
            mean_lanes=statistics.fmean(self.lanes),
            decode_tokens=sum(self.lanes),
            decode_tok_s=sum(self.lanes) / sum(self.decode_s),
            mean_hops=self.eng.pager.stats["hops"]
            / max(self.eng.pager.stats["searches"], 1),
            walk_rounds=cfg_attr(self.eng.pager.index.cfg,
                                 "walk_round_cap"),
            index_checks=self.index_checks)


def dense_check(model, req, logits, rel_tol: float | None):
    """Teacher-forced dense decode of one request (`Transformer.prefill` +
    `decode_step` on a dense cache, fed the request's own tokens): the
    prefill token must be equal; each decode step's logits must be equal
    in argmax (``rel_tol`` None: the exact leg) or within ``rel_tol`` of
    the largest |logit|.  Returns (steps, argmax matches, max |diff|, max
    |logit|)."""
    import torch

    out = req.out
    n = len(out)
    dev = model.device
    caches = model.init_caches(1, len(req.prompt) + n)
    lg, caches = model.prefill(torch.as_tensor(req.prompt, device=dev)[None],
                               caches)
    check(int(lg[0, -1].argmax()) == out[0],
          f"request {req.seq_id}: prefill token differs from the dense one")
    check(len(logits) == n - 1, f"request {req.seq_id}: {len(logits)} "
                                f"decode logits for {n - 1} tokens")
    match, diff, mag = 0, 0.0, 0.0
    ln = len(req.prompt)
    for j in range(1, n):
        lg, caches = model.decode_step(
            torch.tensor([[out[j - 1]]], dtype=torch.int32, device=dev),
            caches, torch.tensor([ln], dtype=torch.int32, device=dev))
        dense = lg[0, 0]
        tok = int(dense.argmax())
        match += tok == out[j]
        diff = max(diff, float((dense - logits[j - 1]).abs().max()))
        mag = max(mag, float(dense.abs().max()))
        if rel_tol is None:
            check(tok == out[j], f"request {req.seq_id}: token {j} is "
                                 f"{out[j]}, the dense decode's {tok}")
        ln += 1
    if rel_tol is not None:
        check(diff <= rel_tol * mag, f"request {req.seq_id}: logits differ "
                                     f"from the dense decode by {diff} "
                                     f"(> {rel_tol} x {mag})")
    return n - 1, match, diff, mag


def check_serve_counts(counts: dict, layers: int, steps: int, where: str):
    check(counts["paged"] == layers * steps,
          f"{where}: {counts['paged']} paged launches for {steps} decode "
          f"steps of {layers} layers")
    check(counts["fused"] > 0, f"{where}: the lookups did not launch "
                               f"veb_walk_fused")
    check(counts["plain"] == 0, f"{where}: a plain version ran")


def run_engine(eng, prompts, max_new: int) -> float:
    """Submit ``prompts`` and step until every request is done; returns the
    wall seconds."""
    import torch

    t0 = time.perf_counter()
    sids = [eng.submit(p, max_new=max_new) for p in prompts]
    for _ in range(10_000):
        if all(eng.active[s].done for s in sids):
            break
        eng.step()
    torch.cuda.synchronize()
    check(all(eng.active[s].done for s in sids), "a request never finished")
    return time.perf_counter() - t0


def exact_token_leg(rng, device, seed: int) -> dict:
    """Phase 5.2: Granite at full width in float32, cut to 4 layers;
    ServeEngine (lockstep lookups) on 4 requests must give the dense
    decode's tokens exactly."""
    import dataclasses

    import torch

    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import PagerConfig, ServeEngine

    cfg = dataclasses.replace(CONFIG, num_layers=EXACT_LAYERS,
                              dtype="float32", param_dtype="float32")
    model = Transformer(cfg, device=device, seed=seed)
    eng = ServeEngine(cfg, model, PagerConfig(engine="lockstep"),
                      max_batch=EXACT_REQUESTS)
    probe = Probe(eng, check_index=True)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype("int32")
               for n in rng.integers(*EXACT_PROMPT, EXACT_REQUESTS)]
    reset_counts()
    wall = run_engine(eng, prompts, EXACT_NEW)
    counts = read_counts()
    probe.close()
    check_serve_counts(counts, cfg.num_layers, len(probe.lanes),
                       "float32 leg")
    check(len(eng.pager.free_pages) == eng.pager.cfg.num_pages,
          "float32 leg: pages not reclaimed")
    steps = 0
    for sid, req in eng.active.items():
        n, match, _, _ = dense_check(model, req, probe.logits[sid], None)
        steps += n
    row = dict(layers=cfg.num_layers, dtype="float32", requests=len(prompts),
               prompt_lens=[len(p) for p in prompts], wall_s=wall,
               dense_steps_equal=steps, counts=counts, **probe.summary())
    del eng, model, probe
    torch.cuda.empty_cache()
    return row


def full_width_serve(rng, device, seed: int) -> dict:
    """Phase 5.3: the 36-layer bf16 model; 16 requests (prompts in
    128..1024, 32 new tokens each) through ServeEngine with 8 live lanes,
    so slots recycle; the index checked against the pager after every
    applied batch; every request's logits held against the dense decode.
    Then phase 5.4, the churn trace on the same weights."""
    import torch

    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import PagerConfig, ServeEngine

    cfg = CONFIG
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Transformer(cfg, device=device, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"Granite-8B at full width: {model.param_count()} parameters in "
        f"{cfg.param_dtype}, made on the card in {init_s:.2f} s")
    eng = ServeEngine(cfg, model, PagerConfig(engine="lockstep"),
                      max_batch=SERVE_LIVE)
    probe = Probe(eng, check_index=True)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype("int32")
               for n in rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1,
                                     SERVE_REQUESTS)]
    reset_counts()
    wall = run_engine(eng, prompts, SERVE_NEW)
    counts = read_counts()
    probe.close()
    check_serve_counts(counts, cfg.num_layers, len(probe.lanes),
                       "full-width serve")
    pg = eng.pager
    check(len(pg.free_pages) == pg.cfg.num_pages and not pg.seq_blocks,
          "full-width serve: pages not reclaimed")
    steps = match = 0
    diff = mag = rel = 0.0
    for sid, req in eng.active.items():
        n, m, d, g = dense_check(model, req, probe.logits[sid],
                                 LOGIT_REL_TOL_BF16)
        steps, match = steps + n, match + m
        diff, mag, rel = max(diff, d), max(mag, g), max(rel, d / g)
    check(match >= TOKEN_MATCH_MIN_BF16 * steps, f"full-width serve: {match} "
          f"of {steps} decode steps match the dense decode's argmax")
    serve = dict(layers=cfg.num_layers, dtype=cfg.dtype,
                 params=model.param_count(), init_s=init_s,
                 requests=SERVE_REQUESTS, max_new=SERVE_NEW,
                 live=SERVE_LIVE, wall_s=wall,
                 tok_s=(probe.summary()["decode_tokens"] + SERVE_REQUESTS)
                 / wall,
                 token_match=match / steps, dense_steps=steps,
                 max_logit_diff=diff, max_logit=mag, max_logit_rel=rel,
                 counts=counts,
                 pager=dict(pg.stats), obs=eng.obs.asdict(),
                 **probe.summary())
    del eng, probe
    torch.cuda.empty_cache()
    serve["device_ms"] = trace_steps(model, rng)
    log(json.dumps({"serve_full_width": serve}))
    churn = churn_trace(model, rng, seed)
    return dict(serve=serve, churn=churn)


def churn_trace(model, rng, seed: int) -> dict:
    """Phase 5.4: the synthesized churn trace (arrivals in bursts, cancels,
    zipf probes) at full width under deferred maintenance with the worker's
    high-water mark; one scan of the live sequences mid-trace, checked
    against their block tables; every finished request's logits held
    against the dense decode."""
    import numpy as np
    import torch

    from repro_torch.serve import SchedulerConfig, ServeScheduler, synth_trace
    from repro_torch.serving import PagerConfig

    cfg = model.cfg
    pc = PagerConfig(engine="lockstep", maintenance="deferred",
                     maint_high_water=CHURN_HIGH_WATER)
    sch = ServeScheduler(cfg, model, pc, SchedulerConfig())
    probe = Probe(sch, check_index=False)
    plans = synth_trace(CHURN_STEPS, seed, arrive_p=0.6, burst=2,
                        prompt_lens=(16, 512), max_new=(8, 32),
                        cancel_p=0.25, probes_per_step=32,
                        vocab=cfg.vocab_size)
    reset_counts()
    t0 = time.perf_counter()
    sch.run_trace(plans[:CHURN_SPLIT], drain=False)
    live = [r.seq_id for _, r in sch.queue.live()]
    check(live, "churn: no live sequence to scan")
    pages = sch.scan(live)
    maxb = max(int(pg.size) for pg in pages.values()) + 1
    table = sch.pager.block_tables(live, maxb).cpu().numpy()
    for i, sid in enumerate(live):
        row = table[i]
        want = row[: int((row >= 0).sum())]
        check(np.array_equal(pages[sid], want) and (row[want.size:] < 0).all(),
              f"churn: scan of sequence {sid} differs from its block table")
    summary = sch.run_trace(plans[CHURN_SPLIT:])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    probe.close()
    check_serve_counts(counts, cfg.num_layers, len(probe.lanes), "churn")
    ws = sch.worker.stats()
    check(ws["drains"] > 0, "churn: the worker never drained")
    check(sch.pager.stats["inline_maint"] == 0,
          "churn: the decode path ran structural maintenance")
    check(len(sch.pager.free_pages) == pc.num_pages,
          "churn: pages not reclaimed")
    check(sch.pager.pending == 0, "churn: maintenance left pending")
    steps = match = finished = 0
    diff = rel = 0.0
    for sid, req in sch.active.items():
        if not req.done:
            continue
        finished += 1
        n, m, d, g = dense_check(model, req, probe.logits.get(sid, []),
                                 LOGIT_REL_TOL_BF16)
        steps, match, diff = steps + n, match + m, max(diff, d)
        rel = max(rel, d / g) if g else rel
    check(finished > 0, "churn: no request finished")
    check(match >= TOKEN_MATCH_MIN_BF16 * steps, f"churn: {match} of "
          f"{steps} decode steps match the dense decode's argmax")
    row = dict(summary, wall_s=wall, finished_checked=finished,
               token_match=match / max(steps, 1), max_logit_diff=diff,
               max_logit_rel=rel,
               scanned=len(live), worker=ws, counts=counts,
               pager=dict(sch.pager.stats), obs=sch.obs.asdict(),
               scan_obs=sch.scan_obs.asdict(), **probe.summary())
    log(json.dumps({"churn": row}))
    del sch, probe
    torch.cuda.empty_cache()
    return row


def serve_phase(seed: int, device) -> dict:
    """Phase 5, in order: kernel vs plain and timings, the float32
    exact-token leg, the full-width serve and the churn trace."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed + 5)
    t0 = time.perf_counter()
    kern = compare_paged(rng, device, seed)
    log(f"phase 5.1 done at {time.perf_counter() - t0:.1f} s")
    exact = exact_token_leg(rng, device, seed)
    log(json.dumps({"serve_float32_exact": exact}))
    log(f"phase 5.2 done at {time.perf_counter() - t0:.1f} s")
    full = full_width_serve(rng, device, seed)
    log(f"phase 5.3-5.4 done at {time.perf_counter() - t0:.1f} s")
    return dict(kernel=kern, exact=exact, **full)


# --------------------------------------------------------------------------
# phase 6: the DeltaForest at benchmarks/forest_scale.py --full size
# --------------------------------------------------------------------------

FOREST_KEY_MAX = 2_000_000      # benchmarks/forest_scale.py KEY_MAX
FOREST_INITIAL = 500_000        # --full initial_size (draws; ~442 k unique)
FOREST_TOTAL_OPS = 100_000      # --full total_ops; sizes the arenas
FOREST_UPDATE_PCT = 5.0
FOREST_SHARDS = (1, 2, 4, 8)
FOREST_BATCHES = (256, 1024, 4096)
FOREST_WARMUP = 2               # run_index's warm-up steps, off the clock
FOREST_EXACT = ((1, 0), (4, 0), (8, 0), (4, 12))   # 6.1: (S, payload bits)
FOREST_CHECK_K = 1021           # 6.1 read batch: no multiple of 4 or 64
FOREST_SCAN_K = 509             # 6.1 scan bands, likewise
FOREST_CHECK_STEPS = 3          # 6.1 update batches (50 % updates)
FOREST_WALK_K = 1024            # 6.3: kernel 2's batch
FOREST_SCAN_LANES = 512         # 6.3: kernel 3's bands (x S tiled lanes)
SHARDED_SHARDS = 4              # 6.4: ShardedPagerConfig(num_shards=4)


def forest_config(n_keys: int, shards: int) -> dict:
    """benchmarks/common.py::backend_kwargs("forest", ...)."""
    n_eff = n_keys + FOREST_TOTAL_OPS // 2
    height = 7
    return dict(num_shards=shards, key_max=FOREST_KEY_MAX, height=height,
                buf_cap=32, max_rounds=256,
                max_dnodes=max(64, int(8 * n_eff / shards
                                       / 2 ** (height - 1))))


def forest_traffic(seed: int, batch: int, initial) -> dict:
    """benchmarks/common.py::run_index's stream for one batch size (its rng
    seeded with ``seed``; 2 warm-up steps, then total_ops // batch), with
    the set oracle's answers: each step's search on the pre-step set, then
    its update rows in batch order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    live = set(initial.tolist())
    steps = []
    for _ in range(FOREST_WARMUP + max(FOREST_TOTAL_OPS // batch, 1)):
        kinds = mixed_kinds(rng, batch, FOREST_UPDATE_PCT)
        keys = rng.integers(1, FOREST_KEY_MAX, size=batch).astype(np.int32)
        found = np.fromiter((k in live for k in keys.tolist()), bool, batch)
        res = np.zeros(batch, bool)
        for i in np.flatnonzero(kinds):
            k = int(keys[i])
            if kinds[i] == 1:
                res[i] = k not in live
                live.add(k)
            else:
                res[i] = k in live
                live.discard(k)
        steps.append((kinds, keys, found, res))
    return dict(steps=steps, live=np.asarray(sorted(live), np.int64))


def copy_index(ix, **cfg_kw):
    """A second Index over a copy of ``ix``'s state on the card (one
    device copy instead of another host build); ``cfg_kw`` replaces
    ForestConfig fields, ``maintenance=`` the per-shard policy."""
    import dataclasses

    from repro_torch.api import Index, IndexSpec

    st = ix.state
    cfg = ix.cfg
    policy = cfg_kw.pop("maintenance", None)
    if policy is not None:
        cfg = dataclasses.replace(cfg, tree=dataclasses.replace(
            cfg.tree, maintenance=policy))
    if cfg_kw:
        cfg = dataclasses.replace(cfg, **cfg_kw)
    if hasattr(st, "trees"):
        st = st._replace(trees=type(st.trees)(*(x.clone() for x in st.trees)),
                         reads=st.reads.clone(), updates=st.updates.clone(),
                         epoch=0)
    else:
        st = type(st)(*(x.clone() for x in st))
    return Index(IndexSpec(backend=ix.spec.backend, cfg=cfg), st)


def boundary_keys(ix, live):
    """Keys at every shard boundary (split - 1, split, split + 1), the
    live extremes, keys above the last live key (the cross-shard
    successor falls through to nothing) and below the domain."""
    import numpy as np

    sp = ix.state.splits.cpu().numpy().astype(np.int64)
    top = int(live[-1])
    ks = np.concatenate([sp - 1, sp, sp + 1,
                         [0, 1, int(live[0]), top, top + 1, top + 500,
                          FOREST_KEY_MAX + 5]])
    return ks.astype(np.int32)


def same_cols(a, b, where: str) -> None:
    """Two read results equal bit for bit, dtypes included."""
    import torch

    for i, (x, y) in enumerate(zip(a, b)):
        check(x.dtype == y.dtype and torch.equal(x, y),
              f"{where}: column {i} differs between the dispatches")


def forest_reads_agree(ixf, ixd, live, pays, q, rng, where: str) -> dict:
    """6.1: one read batch three ways — the fused frontier, the dense
    per-shard dispatch and the oracle: lookup / search (found, payload,
    hops), successor, scans (sparse and dense bands, max_out 128) and
    successor_k.  The fused reads run alone between a counter reset and a
    read, then the dense reads the same way; returns the fused reads'
    counts (walk and scan launched, no plain version)."""
    import numpy as np

    from repro_torch.core.layout import KEY_MAX as DOMAIN_MAX

    bits = ixf.cfg.tree.payload_bits
    bands = [scan_bands(rng, live.size, FOREST_SCAN_K, density, 128,
                        FOREST_KEY_MAX) for density in DENSITY_FILL]
    names = ("search", "successor",
             *(f"{d} scan" for d in DENSITY_FILL), "successor_k")

    def reads(ix):
        return [ix.lookup(q) if bits else ix.search(q), ix.successor(q),
                *(ix.spec.backend.scan(ix.cfg, ix.state, st, hi, 128)
                  for st, hi in bands),
                ix.successor_k(q[:FOREST_SCAN_K], 16)]

    reset_counts()
    got = reads(ixf)
    counts = read_counts()
    check(counts["fused"] > 0 and counts["scan"] > 0
          and counts["plain"] == 0, f"{where}: fused reads' launches {counts}")
    reset_counts()
    dense = reads(ixd)
    dcounts = read_counts()
    check(dcounts["plain"] == 0, f"{where}: dense reads ran a plain version")
    for name, a, b in zip(names, got, dense):
        same_cols(a, b, f"{where}: {name}")
    found = got[0]
    idx = np.searchsorted(live, q)
    hit = (idx < live.size) & (live[np.minimum(idx, live.size - 1)] == q)
    check((found[0].cpu().numpy() == hit).all(),
          f"{where}: search differs from the oracle")
    if bits:
        check((found[1].cpu().numpy()[hit] == pays[idx[hit]]).all(),
              f"{where}: payloads differ from the oracle")
    sf, sk = got[1]
    idx = np.searchsorted(live, q, side="right")
    want_f = idx < live.size
    want_k = np.where(want_f, live[np.minimum(idx, live.size - 1)], 0)
    check((sf.cpu().numpy() == want_f).all()
          and (sk.cpu().numpy() == want_k).all(),
          f"{where}: successor differs from the oracle")
    for density, (st, hi), res in zip(DENSITY_FILL, bands, got[2:-1]):
        check_scan(res, live, st, hi, 128, f"{where}, {density} scan")
    check_scan(got[-1], live, q[:FOREST_SCAN_K],
               np.full(FOREST_SCAN_K, DOMAIN_MAX), 16, f"{where}, succ_k")
    return counts


def forest_exact(ix0, rng, where: str) -> dict:
    """6.1 on one forest: reads three ways on the built forest, after each
    of ``FOREST_CHECK_STEPS`` update batches (both dispatches' arenas
    equal after each), and under ``deferred`` after a batch of clustered
    inserts that leaves items buffered in several shards (then flush);
    every shard's alloc_fail and the final live set.  The fused reads'
    launches are counted in windows of their own (forest_reads_agree);
    the updates and the flush in theirs, where no plain version may run."""
    import collections

    import numpy as np
    import torch

    from repro_torch.api import OpBatch

    ixf, ixd = copy_index(ix0), copy_index(ix0, fused=False)
    bits = ix0.cfg.tree.payload_bits
    items = ix0.live_items()
    live = np.asarray([k for k, _ in items], np.int64)
    pays = np.asarray([p for _, p in items], np.int64)
    oracle = dict(items)

    def batch():
        q = rng.integers(0, FOREST_KEY_MAX + 1000,
                         FOREST_CHECK_K).astype(np.int32)
        b = boundary_keys(ixf, live)
        q[:b.size] = b
        q[b.size: b.size + FOREST_CHECK_K // 2] = rng.choice(
            live, FOREST_CHECK_K // 2)
        return q

    def no_plain(what: str) -> None:
        c = read_counts()
        check(c["plain"] == 0, f"{where}: {what} ran a plain version {c}")

    fused = collections.Counter(forest_reads_agree(
        ixf, ixd, live, pays, batch(), rng, f"{where}, built"))
    for step in range(FOREST_CHECK_STEPS):
        kinds = mixed_kinds(rng, FOREST_CHECK_K, 50)
        keys = rng.integers(1, FOREST_KEY_MAX, FOREST_CHECK_K).astype(np.int32)
        keys[:64] = rng.choice(live, 64)
        pp = (keys % 4096).astype(np.int32)
        want = np.zeros(keys.size, bool)
        for i in np.flatnonzero(kinds):
            k = int(keys[i])
            want[i] = (k not in oracle) if kinds[i] == 1 else (k in oracle)
            if kinds[i] == 1 and want[i]:
                oracle[k] = int(pp[i]) if bits else 0
            elif kinds[i] == 2:
                oracle.pop(k, None)
        reset_counts()
        ixf, res, st = ixf.update(OpBatch.mixed(kinds, keys, pp))
        ixd, resd, std = ixd.update(OpBatch.mixed(kinds, keys, pp))
        no_plain(f"update {step}")
        check((res.cpu().numpy() == want).all() and torch.equal(res, resd)
              and st == std, f"{where}: update results differ at {step}")
        check(all(torch.equal(a, b) for a, b in zip(ixf.state.trees,
                                                    ixd.state.trees)),
              f"{where}: the dispatches' arenas differ after step {step}")
        live = np.asarray(sorted(oracle), np.int64)
        pays = np.asarray([oracle[k] for k in live.tolist()], np.int64)
        fused.update(forest_reads_agree(ixf, ixd, live, pays, batch(), rng,
                                        f"{where}, step {step}"))
    check(not bool(ixf.state.trees.alloc_fail.any()),
          f"{where}: a shard's arena allocation failed")
    check(ixf.live_items() == sorted(oracle.items()),
          f"{where}: live items differ from the oracle")
    # deferred: clustered inserts fill overflow buffers in several shards
    qf = copy_index(ixf, maintenance="deferred")
    qd = copy_index(ixf, maintenance="deferred", fused=False)
    runs = (rng.choice(live, FOREST_CHECK_K // 8)[:, None]
            + np.arange(1, 9)).reshape(-1).astype(np.int32)
    ones = np.ones(runs.size, np.int32)
    pr = (runs % 4096).astype(np.int32)
    reset_counts()
    qf, res, st = qf.update(OpBatch.mixed(ones, runs, pr))
    qd, resd, _ = qd.update(OpBatch.mixed(ones, runs, pr))
    no_plain("the deferred update")
    for k, p, ok in zip(runs.tolist(), pr.tolist(), res.cpu().tolist()):
        check(ok == (k not in oracle), f"{where}: deferred insert result")
        oracle.setdefault(k, p if bits else 0)
    buffered = int((qf.state.trees.bcount.sum(1) > 0).sum())
    check(st.pending > 0 and buffered >= min(2, ix0.cfg.num_shards),
          f"{where}: the deferred batch left {st.pending} items buffered "
          f"in {buffered} shards")
    live = np.asarray(sorted(oracle), np.int64)
    pays = np.asarray([oracle[k] for k in live.tolist()], np.int64)
    fused.update(forest_reads_agree(qf, qd, live, pays, batch(), rng,
                                    f"{where}, deferred"))
    reset_counts()
    qf, fst = qf.flush()
    no_plain("the flush")
    check(fst.pending == 0 and qf.live_items() == sorted(oracle.items())
          and not bool(qf.state.trees.alloc_fail.any()),
          f"{where}: deferred flush")
    return dict(where=where, shards=ix0.cfg.num_shards, payload_bits=bits,
                pending=st.pending, buffered_shards=buffered,
                size=qf.size(), fused_read_counts=dict(fused))


def forest_run(ix, traffic, label: str) -> dict:
    """6.2: one point of the grid — run_index's loop through the Index
    API (search the whole batch, then insert_delete the whole batch with
    its search rows as no-ops), each step checked against the oracle.
    Host-clocked, each call ending in a synchronize; the checks are off
    the clock.  Counters set to 0 before the run and read after; walk
    launches are also counted in the search calls alone."""
    import numpy as np
    import torch

    from repro_torch.api import OpBatch
    from repro_torch.core import deltatree as DT
    from repro_torch.distributed import forest as TF
    from repro_torch.kernels import veb_search as VS

    v0 = TF.fused_view_cache_stats()
    reset_counts()
    search_s, update_s, walks = [], [], []
    for i, (kinds, keys, want_found, want_res) in enumerate(traffic["steps"]):
        n0 = VS.veb_walk_fused.launches
        t0 = time.perf_counter()
        found, _ = ix.search(keys)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n1 = VS.veb_walk_fused.launches
        ix, res = ix.insert_delete(OpBatch.mixed(kinds, keys))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check((found.cpu().numpy() == want_found).all(),
              f"{label}: search differs from the oracle at step {i}")
        check((res.cpu().numpy() == want_res).all(),
              f"{label}: update results differ from the oracle at step {i}")
        if i >= FOREST_WARMUP:
            search_s.append(t1 - t0)
            update_s.append(t2 - t1)
            walks.append(n1 - n0)
    counts = read_counts()
    v1 = TF.fused_view_cache_stats()
    check(counts["fused"] > 0 and counts["plain"] == 0,
          f"{label}: {counts} (the walk kernel must run, no plain version)")
    ops = len(search_s) * len(traffic["steps"][0][0])
    check(not ix.alloc_failed(), f"{label}: arena allocation failed")
    live = (TF.live_keys(ix.cfg, ix.state) if ix.backend == "forest" else
            DT.live_keys(ix.cfg, ix.state))
    check(np.array_equal(live, traffic["live"]),
          f"{label}: live keys differ from the oracle")
    return dict(ops_per_s=ops / (sum(search_s) + sum(update_s)),
                search_ms=statistics.median(search_s) * 1e3,
                update_ms=statistics.median(update_s) * 1e3,
                walk_launches_per_search=statistics.fmean(walks),
                view_builds=v1["builds"] - v0["builds"],
                view_hits=v1["hits"] - v0["hits"], steps=len(search_s),
                counts=counts)


def forest_kernels(ix, rng, flush) -> dict:
    """6.3: kernels 2 and 3 on one forest's fused view, as the fused path
    launches them: kernel 2 on a batch of ``FOREST_WALK_K`` keys in batch
    order (each lane seeded at its shard's root), kernel 3 on
    ``FOREST_SCAN_LANES`` dense bands tiled shard-major (lane s*k + i).
    Each against its plain version (exact), timed (CUDA events, L2
    flushed), beside its byte bound and the share of lanes whose root is
    the one their block staged."""
    import torch

    from repro_torch.core import engine as E
    from repro_torch.distributed import router as R
    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS
    from repro_torch.kernels.ops import scan_round_cap

    cfg = ix.cfg.tree
    s = ix.cfg.num_shards
    dev = ix.state.splits.device
    view, roots = E._fused_trees_view(cfg, ix.state.trees)
    h, cap = cfg.height, cfg.walk_round_cap
    keys = torch.as_tensor(rng.integers(1, FOREST_KEY_MAX, FOREST_WALK_K),
                           dtype=torch.int32, device=dev)
    q = E._walk_queries(cfg, keys).contiguous()
    r = roots[R.shard_ids(ix.state.splits, keys).long()].contiguous()

    def walk():
        return VS.veb_walk_fused(view.value, view.child, r, q, height=h,
                                 max_rounds=cap)

    def walk_plain():
        return ref.ref_delta_walk_fused(view.value, view.child, r, q,
                                        height=h, max_rounds=cap)

    got, want = walk(), walk_plain()
    err = max(int((a.long() - b.long()).abs().max())
              for a, b in zip(got, want))
    check(err == 0, f"veb_walk_fused != plain on the fused view, S={s}")
    wb, _ = fused_needs(view, h, q, r, cap)
    lane = torch.arange(FOREST_WALK_K, device=dev)
    block = walk_threads()
    walk_row = dict(ms=cuda_ms(walk, 20, flush),
                    plain_ms=cuda_ms(walk_plain, 3, flush), bytes=wb,
                    bound_ms=bound_ms(wb), err=err,
                    staged_root_share=float(
                        (r == r[lane // block * block]).float().mean()),
                    mean_hops=float(got[3].float().mean()))
    n_keys = int(ix.size())
    st, hi = scan_bands(rng, n_keys, FOREST_SCAN_LANES, "dense", 128,
                        FOREST_KEY_MAX)
    sp, hp = pack_bands(cfg, st, hi, dev)
    sp, hp = sp.repeat(s).contiguous(), hp.repeat(s).contiguous()
    lid = torch.arange(s, device=dev).repeat_interleave(FOREST_SCAN_LANES)
    sr = roots[lid].contiguous()
    scap = scan_round_cap(h, view.value.shape[0], 128)
    args = (view.value, view.mark, view.child, sr, sp, hp)
    kw = dict(height=h, max_out=128, pmask=cfg.pmask, max_rounds=scap)
    got = VS.veb_scan_fused(*args, **kw)
    want = ref.ref_delta_scan_fused(*args, **kw)
    serr = max(int((a.long() - b.long()).abs().max())
               for a, b in zip(got, want))
    check(serr == 0, f"veb_scan_fused != plain on the fused view, S={s}")
    sb, n_replay = scan_needs(view, h, sr, sp, hp, 128, cfg.pmask, scap)
    check(torch.equal(n_replay, got[1]), "scan byte replay diverged")
    tl = torch.arange(sr.numel(), device=dev)
    scan_row = dict(ms=cuda_ms(lambda: VS.veb_scan_fused(*args, **kw), 10,
                               flush),
                    plain_ms=None, bytes=sb, bound_ms=bound_ms(sb), err=serr,
                    lanes=int(sr.numel()),
                    staged_root_share=float(
                        (sr == sr[tl // 4 * 4]).float().mean()),
                    emitted=int(got[1].sum()))
    return dict(shards=s, walk=walk_row, scan=scan_row)


def sharded_serve_leg(rng, device, seed: int) -> dict:
    """6.4: phase 5.2's float32 exact-token leg (Granite at full width, 4
    layers) served twice from the same weights and prompts, over the
    single-tree pager and over ``ShardedPagerConfig(num_shards=4)``: the
    sharded run's tokens must equal the dense decode's, its block tables
    the single-tree pager's at every step, and the fused view must be
    reused (view_hits > 0).  Counters set to 0 before the sharded run."""
    import dataclasses

    import torch

    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import (
        PagerConfig, ServeEngine, ShardedDeltaPager, ShardedPagerConfig,
    )

    cfg = dataclasses.replace(CONFIG, num_layers=EXACT_LAYERS,
                              dtype="float32", param_dtype="float32")
    model = Transformer(cfg, device=device, seed=seed)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype("int32")
               for n in rng.integers(*EXACT_PROMPT, EXACT_REQUESTS)]
    runs = {}
    for name, pc in (("tree", PagerConfig(engine="lockstep")),
                     ("forest", ShardedPagerConfig(num_shards=SHARDED_SHARDS,
                                                   engine="lockstep"))):
        eng = ServeEngine(cfg, model, pc, max_batch=EXACT_REQUESTS)
        probe = Probe(eng, check_index=True)
        tables = []
        lookup = eng.pager.block_tables

        def recorded(sids, n, lookup=lookup, tables=tables):
            out = lookup(sids, n)
            tables.append(out.cpu())
            return out

        eng.pager.block_tables = recorded
        reset_counts()
        wall = run_engine(eng, prompts, EXACT_NEW)
        counts = read_counts()
        probe.close()
        check_serve_counts(counts, cfg.num_layers, len(probe.lanes),
                           f"{name} pager")
        runs[name] = dict(eng=eng, probe=probe, tables=tables, wall=wall,
                          counts=counts)
    tree, forest = runs["tree"], runs["forest"]
    eng = forest["eng"]
    check(isinstance(eng.pager, ShardedDeltaPager)
          and eng.pager.index.capability.fused_forest,
          "sharded leg: the pager is not a fused forest")
    check(len(tree["tables"]) == len(forest["tables"])
          and all(torch.equal(a, b) for a, b in zip(tree["tables"],
                                                    forest["tables"])),
          "sharded leg: block tables differ from the single-tree pager's")
    steps = 0
    for sid, req in eng.active.items():
        check(req.out == tree["eng"].active[sid].out,
              f"sharded leg: request {sid}'s tokens differ")
        n, _, _, _ = dense_check(model, req, forest["probe"].logits[sid],
                                 None)
        steps += n
    obs = eng.obs.asdict()
    check(obs["view_hits"] > 0, "sharded leg: the fused view was never reused")
    check(len(eng.pager.free_pages) == eng.pager.cfg.num_pages,
          "sharded leg: pages not reclaimed")
    row = dict(layers=cfg.num_layers, shards=SHARDED_SHARDS,
               requests=len(prompts), steps_compared=len(forest["tables"]),
               dense_steps_equal=steps, wall_s=forest["wall"],
               tree_wall_s=tree["wall"], counts=forest["counts"],
               view_hits=obs["view_hits"], view_builds=obs["view_builds"],
               forest_lookup_ms=forest["probe"].summary()["lookup_ms"],
               tree_lookup_ms=tree["probe"].summary()["lookup_ms"],
               mean_hops=forest["probe"].summary()["mean_hops"])
    del runs, tree, forest, eng, model
    torch.cuda.empty_cache()
    return row


def forest_phase(seed: int, device) -> dict:
    """Phase 6, in order: 6.1 exactness at S = 1, 4, 8 (set) and S = 4
    (map); 6.2 the timed grid S x batch under both dispatches, beside the
    deltatree baseline; 6.3 kernels 2 and 3 on the fused views of S = 1
    and S = 8; 6.4 the sharded pager serve leg."""
    import numpy as np
    import torch

    from repro_torch.api import make_index
    from repro_torch.distributed import forest as TF

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 6)
    keys = np.unique(rng.integers(1, FOREST_KEY_MAX, FOREST_INITIAL)
                     .astype(np.int32))
    n = int(keys.size)
    log(f"forest: {n} keys, per shard {forest_config(n, 1)} at S = 1")
    TF.reset_fused_view_cache()
    traffic = {b: forest_traffic(seed, b, keys) for b in FOREST_BATCHES}
    exact, grid, built, kern = [], [], {}, []
    launches = dict(fused=0, scan=0)
    base = make_index("deltatree", initial=keys, engine="lockstep",
                      device=device, **fig12_config(n, FOREST_TOTAL_OPS))
    base_rows = {}
    for b in FOREST_BATCHES:
        base_rows[b] = forest_run(copy_index(base), traffic[b],
                                  f"deltatree, batch {b}")
        log(json.dumps({"forest_grid": dict(backend="deltatree", batch=b,
                                            **base_rows[b])}))
    del base
    for s in FOREST_SHARDS:
        tb = time.perf_counter()
        ix0 = make_index("forest", initial=keys, engine="lockstep",
                         device=device, **forest_config(n, s))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - tb
        arena = sum(x.numel() * x.element_size() for x in ix0.state.trees)
        log(f"forest S={s}: built in {build_s:.2f} s, {arena / 1e6:.1f} MB "
            f"of arena, splits {ix0.state.splits.tolist()}")
        if (s, 0) in FOREST_EXACT:
            exact.append(forest_exact(ix0, rng, f"S={s} set"))
            log(json.dumps({"forest_exact": exact[-1]}))
            launches["scan"] += exact[-1]["fused_read_counts"]["scan"]
        for b in FOREST_BATCHES:
            rows = {}
            for dispatch in ("fused", "dense"):
                ix = copy_index(ix0, fused=dispatch == "fused")
                rows[dispatch] = forest_run(ix, traffic[b],
                                            f"S={s} {dispatch}, batch {b}")
                del ix
            launches["fused"] += rows["fused"]["counts"]["fused"]
            f, d = rows["fused"], rows["dense"]
            check(f["walk_launches_per_search"] == 1
                  and d["walk_launches_per_search"] == s,
                  f"S={s}, batch {b}: walk launches a search batch "
                  f"{f['walk_launches_per_search']} fused, "
                  f"{d['walk_launches_per_search']} dense")
            point = dict(shards=s, batch=b, arena_mb=arena / 1e6,
                         build_s=build_s,
                         baseline_ops_per_s=base_rows[b]["ops_per_s"],
                         speedup=f["ops_per_s"] / base_rows[b]["ops_per_s"],
                         speedup_vs_vmap=f["ops_per_s"] / d["ops_per_s"],
                         fused=f, dense=d)
            grid.append(point)
            log(json.dumps({"forest_grid": point}))
        if s in (1, 8):
            built[s] = ix0
        else:
            del ix0
        torch.cuda.empty_cache()
    log(f"phase 6.1-6.2 done at {time.perf_counter() - t0:.1f} s")
    ixm = make_index("forest", initial=keys, payloads=keys % 4096,
                     engine="lockstep", device=device, payload_bits=12,
                     **forest_config(n, 4))
    exact.append(forest_exact(ixm, rng, "S=4 map"))
    launches["scan"] += exact[-1]["fused_read_counts"]["scan"]
    log(json.dumps({"forest_exact": exact[-1]}))
    del ixm
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
    for s in (1, 8):
        kern.append(forest_kernels(built[s], rng, flush))
        log(json.dumps({"forest_kernels": kern[-1]}))
    del flush, built
    torch.cuda.empty_cache()
    log(f"phase 6.3 done at {time.perf_counter() - t0:.1f} s")
    serve = sharded_serve_leg(rng, device, seed)
    log(json.dumps({"sharded_serve": serve}))
    elapsed = time.perf_counter() - t0
    log(f"phase 6 done in {elapsed:.1f} s")
    return dict(exact=exact, grid=grid, kernels=kern, serve=serve,
                launches=dict(launches, paged=serve["counts"]["paged"]),
                elapsed_s=elapsed)


# --------------------------------------------------------------------------
# phase 7: the paper's comparison structures and the read-path accounting
# --------------------------------------------------------------------------

TABLE1_INITIAL = 1 << 20        # benchmarks/table1_transfers.py INITIAL
TABLE1_QUERIES = 500            # table1_transfers.py --full n_queries
TABLE1_DT = dict(height=7, max_dnodes=1 << 17, buf_cap=16)  # its deltatree
TABLE1_ROWS = ("deltatree", "static_veb", "pointer_bst", "sorted_array")
FIG12_RATES = (0, 10)           # fig12_big_tree.py --quick update rates
FIG12_WARMUP = 2                # run_index's warm-up steps, off the clock
UPDATE_CHUNK = 64               # benchmarks/common.py: baselines' update
#                                 rows a step (a fixed-width OpBatch)
IDLE_STEPS = 3                  # Fig. 12 steps traced for the idle share
STATS_K = 1021                  # 7.4 forest read batch: no multiple of 4


def table1_row(label: str, ix, q) -> dict:
    """benchmarks/table1_transfers.py's row: the mean elements a search
    touches (``loads``) and distinct 16- / 128-element blocks, from the
    backend's host touch trace."""
    import numpy as np

    from repro_torch.core.baselines import count_block_transfers

    t0 = time.perf_counter()
    tf = ix.touch_fn()
    check(tf is not None, f"table 1: {label} has no touch trace")
    row = dict(backend=label,
               loads=float(np.mean([len(tf(int(k))) for k in q])),
               blocks_b16=count_block_transfers(tf, q, 16),
               blocks_b128=count_block_transfers(tf, q, 128))
    row["model_s"] = time.perf_counter() - t0
    return row


def same_stats(a, b, where: str) -> None:
    """Two stats tuples (nested ReadStats included) equal field for field."""
    import torch

    check(type(a) is type(b), f"{where}: {type(a)} vs {type(b)}")
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            check(x is None and y is None, f"{where}.{name}: one is None")
        elif hasattr(x, "_fields"):
            same_stats(x, y, f"{where}.{name}")
        else:
            check(x.dtype == y.dtype and torch.equal(x, y),
                  f"{where}.{name}: {x.tolist()} vs {y.tolist()}")


def deltatree_transfers(ix, q) -> dict:
    """7.1 on the ``deltatree`` row: ``compare_model`` replays on the card
    (ratio 1.0 exactly at every B), and a ``collect_stats`` +
    ``collect_transfers`` search through kernel 2 gives the found / hops
    of a plain read of the same batch and the TransferStats of
    ``measure``.  Returns the ratios and the stats read's counts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import deltatree as DT
    from repro_torch.obs import transfers as OTR

    cm = OTR.compare_model(ix.cfg, ix.state, q)
    check(all(v["ratio"] == 1.0 for v in cm.values()),
          f"table 1: measured / model transfers {cm}")
    cfg = dataclasses.replace(ix.cfg, collect_stats=True,
                              collect_transfers=True)
    reset_counts()
    found, hops, rs = DT.search_batch(cfg, ix.state, q)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["fused"] == 1 and counts["plain"] == 0,
          f"table 1: the stats search ran {counts}")
    found0, hops0 = ix.search(q)
    check(torch.equal(found, found0) and torch.equal(hops, hops0),
          "table 1: the stats search differs from a plain read")
    same_stats(rs.transfers, OTR.measure(ix.cfg, ix.state, q),
               "table 1 transfers")
    check(int(rs.search.queries) == q.size, "table 1: search stats")
    return dict(ratios={b: v["ratio"] for b, v in cm.items()},
                measured_b16=cm[16]["measured"], counts=counts,
                read_stats=dict(search=rs.search.asdict(),
                                transfers=rs.transfers.asdict()),
                hops_mean=float(np.mean(hops.cpu().numpy())))


def table1_phase(seed: int, device) -> dict:
    """7.1: benchmarks/table1_transfers.py --full on the card: 1,048,576
    draws in [1, 5,000,000), 500 queries, its four backends and the ΔTree
    UB=N row; the deltatree row's transfers checked three ways; the
    ordering static_veb < sorted_array < pointer_bst; ``fit_log_b``."""
    import numpy as np

    from repro_torch.api import make_index
    from repro_torch.obs import transfers as OTR

    rng = np.random.default_rng(seed)
    vals = np.unique(rng.integers(1, KEY_MAX, size=TABLE1_INITIAL)
                     .astype(np.int32))
    q = rng.integers(1, KEY_MAX, size=TABLE1_QUERIES).astype(np.int32)
    rows, dt = [], None
    for name in TABLE1_ROWS:
        kw = dict(TABLE1_DT, engine="lockstep") if name == "deltatree" else {}
        t0 = time.perf_counter()
        ix = make_index(name, initial=vals, device=device, **kw)
        build_s = time.perf_counter() - t0
        rows.append(dict(table1_row(name, ix, q), build_s=build_s))
        if name == "deltatree":
            dt = deltatree_transfers(ix, q)
        log(json.dumps({"table1": rows[-1]}))
        del ix
    h_big = int(np.ceil(np.log2(vals.size))) + 2
    t0 = time.perf_counter()
    big = make_index("deltatree", initial=vals, height=h_big, max_dnodes=4,
                     buf_cap=16, engine="lockstep", device=device)
    build_s = time.perf_counter() - t0
    rows.append(dict(table1_row(f"deltatree_ubN(h={h_big})", big, q),
                     build_s=build_s))
    log(json.dumps({"table1": rows[-1]}))
    try:           # the walk kernels take heights 1..12 (ROADMAP Queue 3)
        big.search(q[:8])
        check(False, f"a lockstep read at height {h_big} did not raise")
    except ValueError as e:
        check("height" in str(e), f"UB=N read: {e}")
    del big
    by = {r["backend"]: r for r in rows}
    for b in ("blocks_b16", "blocks_b128"):
        check(by["static_veb"][b] < by["sorted_array"][b]
              < by["pointer_bst"][b], f"table 1 ordering at {b}: {rows}")
    t0 = time.perf_counter()
    fit = OTR.fit_log_b(device=device)
    fit_s = time.perf_counter() - t0
    check(fit["r2"] >= 0.98 and len(fit["points"]) == 11,
          f"fit_log_b: {fit}")
    return dict(keys=int(vals.size), queries=int(q.size), rows=rows,
                deltatree=dt, fit=dict(fit, seconds=fit_s))


def fig12_traffic(seed: int, rate: int, initial, chunked: bool) -> dict:
    """run_index's stream at one update rate (batch 1024, its rng seeded
    with ``seed``, 2 warm-up steps then TOTAL_OPS // 1024): per step the
    search keys and the update batch the backend applies (the baselines
    take the first ``UPDATE_CHUNK`` update rows of the step, padded with
    search rows; the ΔTree the whole batch), with the oracle's answers."""
    import numpy as np

    rng = np.random.default_rng(seed)
    live = set(initial.tolist())
    steps = []
    for _ in range(FIG12_WARMUP + TOTAL_OPS // BATCH):
        kinds = mixed_kinds(rng, BATCH, rate)
        keys = rng.integers(1, KEY_MAX, size=BATCH).astype(np.int32)
        found = np.fromiter((k in live for k in keys.tolist()), bool, BATCH)
        uidx = np.flatnonzero(kinds)
        if chunked:
            uidx = uidx[:UPDATE_CHUNK]
            ukinds = np.zeros(UPDATE_CHUNK, np.int32)
            ukeys = np.zeros(UPDATE_CHUNK, np.int32)
            ukinds[: uidx.size] = kinds[uidx]
            ukeys[: uidx.size] = keys[uidx]
        else:
            ukinds, ukeys = kinds, keys
        res = np.zeros(ukinds.size, bool)
        for i in np.flatnonzero(ukinds):
            k = int(ukeys[i])
            if ukinds[i] == 1:
                res[i] = k not in live
                live.add(k)
            else:
                res[i] = k in live
                live.discard(k)
        steps.append(dict(keys=keys, found=found, ukinds=ukinds, ukeys=ukeys,
                          res=res, ops=int((kinds == 0).sum() + uidx.size)))
    return dict(steps=steps, size=len(live))


def fig12_run(ix, traffic, rate: int, label: str) -> dict:
    """7.2: one backend at one update rate through the Index API, each
    step's search and update results checked against the oracle (off the
    clock).  Host-clocked, each call ending in a synchronize; ops/s counts
    run_index's ops (search rows plus applied update rows) over the timed
    steps' search and update time.  Under ``collect_stats`` the timed
    steps' SearchStats merge on the card, as run_index's do."""
    import torch

    from repro_torch.api import OpBatch

    reset_counts()
    search_s, update_s, ops, acc = [], [], 0, None
    for i, st in enumerate(traffic["steps"]):
        t0 = time.perf_counter()
        res = ix.search(st["keys"])
        found = res[0]
        if ix.collect_stats and i >= FIG12_WARMUP:
            acc = res[-1].search if acc is None else acc.merge(res[-1].search)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if rate:
            ix, res = ix.insert_delete(OpBatch.mixed(st["ukinds"],
                                                     st["ukeys"]))
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        check((found.cpu().numpy() == st["found"]).all(),
              f"{label}: search differs from the oracle at step {i}")
        if rate:
            check((res.cpu().numpy() == st["res"]).all(),
                  f"{label}: update results differ from the oracle at "
                  f"step {i}")
        if i >= FIG12_WARMUP:
            search_s.append(t1 - t0)
            update_s.append(t2 - t1)
            ops += st["ops"]
    counts = read_counts()
    check(counts["plain"] == 0, f"{label}: a plain version ran ({counts})")
    check(ix.backend != "deltatree" or counts["fused"] > 0,
          f"{label}: the walk kernel did not run ({counts})")
    check(ix.size() == traffic["size"], f"{label}: size differs")
    return ix, dict(backend=ix.backend, collect_stats=ix.collect_stats,
                    hops_mean=acc.asdict()["hops_mean"] if acc else None,
                    update_pct=rate, batch=BATCH,
                    ops_per_s=ops / (sum(search_s) + sum(update_s)),
                    search_ms=statistics.median(search_s) * 1e3,
                    update_ms=(statistics.median(update_s) * 1e3
                               if rate else None),
                    steps=len(search_s), counts=counts)


def index_idle_share(ix, rng) -> dict:
    """7.3: ``IDLE_STEPS`` Fig. 12 steps (a 1024-key search, then the
    eager update of the batch at 10 % updates) timed without the
    profiler, then as many under `repro_torch.obs.trace.capture`: device
    busy time a step (one stream, so the sum of kernel times), wall time
    a step and the idle share, 1 - busy / wall, over the same span."""
    import numpy as np
    import torch

    from repro_torch.api import OpBatch
    from repro_torch.obs import trace as OT

    def steps(ix) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(IDLE_STEPS):
            kinds = mixed_kinds(rng, BATCH, UPDATE_PCT)
            keys = rng.integers(1, KEY_MAX, BATCH).astype(np.int32)
            ix.search(keys)
            ix.insert_delete(OpBatch.mixed(kinds, keys))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / IDLE_STEPS

    untraced_ms = steps(ix)
    reset_counts()
    with OT.capture(str(ROOT / "build" / "phase7_trace")) as prof:
        step_ms = steps(ix)
    counts = read_counts()
    check(counts["fused"] > 0 and counts["plain"] == 0,
          f"idle share: {counts}")
    busy = device_split(prof, IDLE_STEPS)["busy"]
    return dict(steps=IDLE_STEPS, step_ms=step_ms,
                untraced_step_ms=untraced_ms, busy_ms=busy,
                idle_share=1 - busy / step_ms if busy > 0 else None,
                counts=counts)


def fig12_phase(keys, seed: int, device) -> dict:
    """7.2-7.3: fig12_big_tree.py's backends on the phase-3 key set at
    batch 1024, 0 % and 10 % updates (static_veb at 0 % only), then the
    ΔTree step's idle share.  The ΔTree runs twice: with ``collect_stats``
    as run_index turns it on (``deltatree+stats``), and without, as phase
    3 runs it (its idle share is taken there).  Each index is built once
    and serves both rates (the 0 % run changes nothing)."""
    import numpy as np
    import torch

    from repro_torch.api import make_index

    tree = dict(engine="lockstep", **fig12_config(keys.size))
    kws = {"deltatree": tree,
           "deltatree+stats": dict(tree, collect_stats=True),
           "pointer_bst": dict(cap=2 * keys.size + TOTAL_OPS + 16),
           "sorted_array": dict(cap=2 * keys.size + TOTAL_OPS + 16),
           "static_veb": {}}
    traffic = {(0, False): fig12_traffic(seed, 0, keys, False)}
    traffic[(0, True)] = traffic[(0, False)]
    for chunked in (False, True):
        traffic[(10, chunked)] = fig12_traffic(seed, 10, keys, chunked)
    runs, builds, launches, idle = [], {}, 0, None
    for name in kws:
        backend = name.split("+")[0]
        t0 = time.perf_counter()
        ix = make_index(backend, initial=keys, device=device, **kws[name])
        torch.cuda.synchronize()
        builds[name] = time.perf_counter() - t0
        for rate in FIG12_RATES if name != "static_veb" else (0,):
            ix, row = fig12_run(ix, traffic[(rate, backend != "deltatree")],
                                rate, f"fig12 {name} {rate} %")
            launches += row["counts"]["fused"]
            runs.append(dict(row, name=name, build_s=builds[name]))
            log(json.dumps({"fig12": runs[-1]}))
        if name == "deltatree":
            idle = index_idle_share(ix, np.random.default_rng(seed + 7))
            launches += idle["counts"]["fused"]
            log(json.dumps({"index_idle": idle}))
        del ix
        torch.cuda.empty_cache()
    log(json.dumps({"fig12_search_ms": {
        f"{r['name']} {r['update_pct']} %": r["search_ms"] for r in runs}}))
    return dict(runs=runs, idle=idle, launches=launches)


def forest_stats_leg(seed: int, device) -> dict:
    """7.4: an S = 4 forest at phase 6's size with ``collect_stats`` and
    ``collect_transfers``: one read batch (shard boundaries, keys above
    the last and below the domain, random keys) through the fused and
    the dense dispatch; found / hops and every ReadStats field equal, the
    router's lanes sum to the batch, found equals the oracle."""
    import numpy as np
    import torch

    from repro_torch.api import make_index

    rng = np.random.default_rng(seed + 6)
    keys = np.unique(rng.integers(1, FOREST_KEY_MAX, FOREST_INITIAL)
                     .astype(np.int32))
    ix = make_index("forest", initial=keys, engine="lockstep", device=device,
                    collect_stats=True, collect_transfers=True,
                    **forest_config(keys.size, 4))
    q = rng.integers(0, FOREST_KEY_MAX + 50, STATS_K).astype(np.int32)
    edge = boundary_keys(ix, keys)
    q[: edge.size] = edge
    out = {}
    for name, view in (("fused", ix), ("dense", copy_index(ix, fused=False))):
        reset_counts()
        out[name] = view.search(q)
        torch.cuda.synchronize()
        out[name + "_counts"] = read_counts()
    f, d = out["fused"], out["dense"]
    check(out["fused_counts"]["fused"] == 1
          and out["dense_counts"]["fused"] == 4
          and out["fused_counts"]["plain"] + out["dense_counts"]["plain"]
          == 0, f"forest stats: {out['fused_counts']} {out['dense_counts']}")
    check(torch.equal(f[0], d[0]) and torch.equal(f[1], d[1]),
          "forest stats: fused and dense reads differ")
    check((f[0].cpu().numpy() == np.isin(q, keys)).all(),
          "forest stats: found differs from the oracle")
    same_stats(f[2], d[2], "forest ReadStats fused vs dense")
    rs = f[2]
    check(int(rs.router.lanes.sum()) == STATS_K
          and int(rs.search.queries) == STATS_K,
          f"forest stats: router lanes {rs.router.lanes.tolist()}")
    row = dict(shards=4, keys=int(keys.size), queries=STATS_K,
               search=rs.search.asdict(), router=rs.router.asdict(),
               transfers=rs.transfers.asdict(),
               counts=dict(fused=out["fused_counts"],
                           dense=out["dense_counts"]))
    del ix, out
    torch.cuda.empty_cache()
    return row


def metrics_serve_leg(rng, device, seed: int) -> dict:
    """7.4: phase 5.2's float32 leg (Granite at full width, 4 layers)
    over ``ShardedPagerConfig(num_shards=4)`` whose forest index collects
    stats and transfers, beside the same run over the stats-free index:
    tokens equal, and ``metrics()`` in dict, Prometheus and JSON form
    with the search, router and transfers groups."""
    import dataclasses

    import torch

    from repro_torch.api import make_index
    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import ServeEngine, ShardedPagerConfig

    cfg = dataclasses.replace(CONFIG, num_layers=EXACT_LAYERS,
                              dtype="float32", param_dtype="float32")
    model = Transformer(cfg, device=device, seed=seed)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype("int32")
               for n in rng.integers(*EXACT_PROMPT, EXACT_REQUESTS)]
    pc = ShardedPagerConfig(num_shards=SHARDED_SHARDS, engine="lockstep")
    fc = pc.forest_config
    runs = {}
    for name, collect in (("plain", False), ("stats", True)):
        ix = make_index("forest", device=device, cfg=dataclasses.replace(
            fc, tree=dataclasses.replace(fc.tree, collect_stats=collect,
                                         collect_transfers=collect)))
        eng = ServeEngine(cfg, model, pc, max_batch=EXACT_REQUESTS, index=ix)
        reset_counts()
        wall = run_engine(eng, prompts, EXACT_NEW)
        runs[name] = dict(eng=eng, wall=wall, counts=read_counts())
    eng = runs["stats"]["eng"]
    counts = runs["stats"]["counts"]
    check(counts["fused"] > 0 and counts["paged"] > 0
          and counts["plain"] == 0, f"metrics leg: {counts}")
    for sid, req in eng.active.items():
        check(req.out == runs["plain"]["eng"].active[sid].out,
              f"metrics leg: request {sid}'s tokens differ with stats on")
    snap = eng.metrics()
    check({"serve", "pager", "maintenance", "search", "router",
           "transfers"} <= set(snap), f"metrics groups {sorted(snap)}")
    check(json.loads(eng.metrics("json")) == snap, "metrics json")
    prom = eng.metrics("prometheus")
    check("repro_router_lanes{index=\"3\"}" in prom
          and "repro_transfers_blocks_b16 " in prom
          and "repro_search_hops_hist{index=\"0\"}" in prom,
          "metrics prometheus")
    check(sum(snap["router"]["lanes"]) == snap["search"]["queries"],
          "metrics: router lanes differ from the batch")
    row = dict(layers=cfg.num_layers, shards=SHARDED_SHARDS,
               requests=len(prompts), wall_s=runs["stats"]["wall"],
               plain_wall_s=runs["plain"]["wall"], counts=counts,
               prometheus_lines=len(prom.splitlines()),
               metrics={k: snap[k] for k in ("search", "router",
                                             "transfers")})
    del runs, eng, model
    torch.cuda.empty_cache()
    return row


def comparison_phase(keys, seed: int, device) -> dict:
    """Phase 7, in order: 7.1 Table 1, 7.2 the Fig. 12 comparison, 7.3 the
    index step's idle share, 7.4 read stats on the forest and the sharded
    serve path.  Returns every row and kernel 2's launches."""
    import numpy as np

    t0 = time.perf_counter()
    table1 = table1_phase(seed, device)
    log(json.dumps({"table1_fit": table1["fit"],
                    "table1_deltatree": table1["deltatree"]}))
    log(f"phase 7.1 done at {time.perf_counter() - t0:.1f} s")
    fig12 = fig12_phase(keys, seed, device)
    log(f"phase 7.2-7.3 done at {time.perf_counter() - t0:.1f} s")
    forest = forest_stats_leg(seed, device)
    log(json.dumps({"forest_stats": forest}))
    serve = metrics_serve_leg(np.random.default_rng(seed + 8), device, seed)
    log(json.dumps({"metrics_serve": serve}))
    elapsed = time.perf_counter() - t0
    log(f"phase 7 done in {elapsed:.1f} s")
    launches = (table1["deltatree"]["counts"]["fused"] + fig12["launches"]
                + forest["counts"]["fused"]["fused"]
                + forest["counts"]["dense"]["fused"]
                + serve["counts"]["fused"])
    return dict(table1=table1, fig12=fig12, forest=forest, serve=serve,
                launches=launches, paged_launches=serve["counts"]["paged"],
                elapsed_s=elapsed)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the kernels rows and the serve phase's "
                         "results to this JSON file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    card, kind = card_check()
    out, serve = run_phases(args.seed, torch.device("cuda"))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "kernels": out,
                                        "serve": serve}, indent=1))
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(seed: int, device):
    """Phases 2-7 on ``device``; returns (the rows of the kernels line, the
    serve phase's results, the forest phase's under ``"forest"`` and phase
    7's under ``"comparison"``)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, KEY_MAX, INITIAL).astype(np.int32))
    log(f"Fig. 12 tree: {keys.size} keys, {fig12_config(keys.size)}")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)

    t_start = time.perf_counter()
    kern = compare_kernels(keys, rng, device, flush)
    del flush
    log(f"phase 2 done at {time.perf_counter() - t_start:.1f} s")

    fused_run, ix, oracle = main_path(keys, rng, device, STEPS,
                                      walk_fused=True)
    log(json.dumps({"main_path": fused_run}))
    c = fused_run["counts"]
    check(c["fused"] > 0, "the main path did not launch veb_walk_fused")
    check(c["plain"] == 0 and c["scan"] == 0,
          "the main path ran a plain version or a scan")
    scan_run = scan_path(ix, oracle, rng)
    log(json.dumps({"scan_path": scan_run}))
    del ix, oracle
    round_run, ix, _ = main_path(keys, rng, device, PER_ROUND_STEPS,
                                 walk_fused=False)
    del ix
    log(json.dumps({"main_path": round_run}))
    c = round_run["counts"]
    check(c["rows"] > 0, "the per-round path did not launch veb_walk_rows")
    check(c["fused"] == 0 and c["plain"] == 0 and c["scan"] == 0,
          "the per-round path ran another walk")
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    for policy, steps in (("deferred", DEFERRED_STEPS),
                          ("budgeted:8", BUDGETED_STEPS)):
        log(json.dumps({"relaxed_path": relaxed_path(keys, rng, device,
                                                     policy, steps)}))
        torch.cuda.empty_cache()
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")
    serve = serve_phase(seed, device)
    log(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")
    serve["forest"] = forest = forest_phase(seed, device)
    log(f"phase 6 done at {time.perf_counter() - t_start:.1f} s")
    serve["comparison"] = comp = comparison_phase(keys, seed, device)
    log(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")

    replaces = {"fused": "src/repro/kernels/veb_search.py:228",
                "rows": "src/repro/kernels/veb_search.py:93",
                "scan": "src/repro/kernels/veb_search.py:397"}
    names = {"fused": "veb_walk_fused", "rows": "veb_walk_rows",
             "scan": "veb_scan_fused"}
    sources = {"fused": SOURCE, "rows": SOURCE, "scan": SCAN_SOURCE}
    launches = {"fused": fused_run["counts"]["fused"],
                "rows": round_run["counts"]["rows"],
                "scan": scan_run["counts"]["scan"]}
    forest_launches = forest["launches"]
    out = []
    for name in ("fused", "rows", "scan"):
        r = kern[name]
        extra = ({} if name == "rows" else
                 {"forest_launches": forest_launches[name]})
        if name == "fused":
            extra["phase7_launches"] = comp["launches"]
        out.append({"name": names[name], "route": "cuda",
                    "source": sources[name], "replaces": replaces[name],
                    "launches": launches[name], **extra,
                    "max_abs_err": r["err"],
                    "exact": r["err"] == 0, "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": "bytes", "library_ms": None,
                    "searchsorted_ms": r["searchsorted_ms"],
                    "K": SCAN_K if name == "scan" else BATCH})
    pa = serve["kernel"]
    out.append({"name": "paged_decode_attention", "route": "cuda",
                "source": PA_SOURCE,
                "replaces": "src/repro/kernels/delta_paged_attention.py:74",
                "launches": serve["serve"]["counts"]["paged"],
                "forest_launches": forest_launches["paged"],
                "phase7_launches": comp["paged_launches"],
                "max_abs_err": pa["max_abs_err"], "exact": False,
                "ms": pa["ms"], "plain_ms": pa["plain_ms"],
                "bound_ms": pa["bound_ms"], "bound_by": "bytes",
                "library_ms": pa["library_ms"], "B": pa["B"],
                "tokens": pa["tokens"], "dtype": pa["dtype"]})
    return out, serve


if __name__ == "__main__":
    sys.exit(main())
