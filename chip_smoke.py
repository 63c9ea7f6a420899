#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero and prints no result line:

1. Card check: require CUDA, print the card's name and power limit
   (``nvidia-smi``), build and load the kernels from
   ``src/repro_torch/kernels/csrc`` and print the build seconds.
2. Each walk kernel against its plain PyTorch version, on the card, in set
   mode (int32) and map mode (int64, ``payload_bits=12``), over a tree of
   the Fig. 12 size after a few update batches and 2**16 queries (present
   and absent keys, walk sentinels, keys above every live key): integer
   outputs must be equal exactly.  ``veb_walk_rows`` is checked in every
   round of the per-round walk, on the rows that walk gathers (each lane's
   current ΔNode, internal ones included).  Times (CUDA events) of the
   kernel, the plain version and ``torch.searchsorted`` (a yardstick only:
   it answers membership over the sorted live keys, not the walk's outputs,
   and the port never calls it), and the kernel's bound: the bytes the walk
   needs (every distinct router slot and child id it reads, queries, roots,
   outputs) over the card's 3.35 TB/s.  The walks do a few integer compares
   per loaded router, so bytes bound them.
3. The main path at the size of the paper's Fig. 12 big tree
   (``benchmarks/fig12_big_tree.py`` with ``benchmarks/common.py``
   ``backend_kwargs``): ``make_index("deltatree", engine="lockstep")`` over
   ~1.97 M keys (height 7, buf_cap 32, ~186 k ΔNodes, ~190 MB of arena),
   then 20 steps of 1024 ops at 10 % updates — ``ix.search`` on the batch, then
   ``ix.insert_delete`` on the whole batch — each checked against the set
   oracle, one 1024-key ``ix.successor`` batch, and the final live set and
   ``alloc_fail``.  Then 3 steps with ``walk_fused=False``, so the
   per-round walk runs ``veb_walk_rows``.  Each of the two runs sets the
   launch counters to 0 just before it and reads them just after: its walk
   kernel must have launched, and no plain version may have run.

The second-to-last line is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
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
SOURCE = "src/repro_torch/kernels/csrc/veb_walk.cu"


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


def fig12_config(n_keys: int) -> dict:
    """benchmarks/common.py::backend_kwargs("deltatree", ...)."""
    n_eff = n_keys + TOTAL_OPS // 2
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


def fused_needs(t, height: int, q, roots, max_rounds: int) -> int:
    """Bytes the fused walk needs on these inputs: every
    distinct (ΔNode, slot) router and child id its lanes read, each once,
    plus queries, roots, outputs and the position table.  A replay of the
    blind descent that records addresses."""
    import torch

    from repro_torch.kernels.ref import pos_table, walk_big

    pos = pos_table(height, q.device).long()
    m, ub = t.value.shape
    lc = t.child.shape[1]
    bottom0 = 2 ** (height - 1)
    vflat = t.value.reshape(-1)
    act = q != walk_big(t.value.dtype)
    dn = roots.long().clone()
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
        caddr = d * lc + (lb - bottom0).clamp(min=0)
        cidx.append(caddr[bottom])
        nxt = torch.where(bottom, t.child.reshape(-1)[caddr].long(), -1)
        dn[lanes] = torch.where(nxt >= 0, nxt, dn[lanes])
        act[lanes] = nxt >= 0
    isz = t.value.element_size()
    k = q.numel()
    distinct_v = torch.unique(torch.cat(vidx)).numel() if vidx else 0
    distinct_c = torch.unique(torch.cat(cidx)).numel() if cidx else 0
    return (distinct_v * isz + distinct_c * 4 + k * (isz + 4)
            + k * (2 * isz + 3 * 4) + pos.numel() * 4)


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


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


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
    from repro_torch.kernels.build import library

    t0 = time.perf_counter()
    library(Path(SOURCE).name)
    log(f"kernels of {SOURCE} built and loaded in "
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


def compare_kernels(keys, rng, device, flush) -> dict:
    """Phase 2.  Returns per-kernel rows for the result line (timed at the
    main path's batch of 1024) and prints the wider timing table."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS

    rows = {}
    sorted_keys = None
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
            fb = fused_needs(t, h, q, roots, cap)
            rb = rows_needs(rws, h, q)
            res = {
                "fused": dict(ms=cuda_ms(fused, reps, flush),
                              plain_ms=cuda_ms(plain, 3, flush),
                              bytes=fb, err=err, bound_ms=bound_ms(fb)),
                "rows": dict(ms=cuda_ms(rows_k, reps, flush),
                             plain_ms=cuda_ms(rows_p, 3, flush),
                             bytes=rb, err=rerr, bound_ms=bound_ms(rb),
                             rounds=rounds),
            }
            ss = cuda_ms(lambda: torch.searchsorted(sorted_keys, keys_q),
                         reps, flush)
            for name, r in res.items():
                r["searchsorted_ms"] = ss
                log(json.dumps({"table": f"veb_walk_{name}", "mode": mode,
                                "K": k, **r}))
                if k == BATCH and bits == 0:
                    rows[name] = r
        del t
        torch.cuda.empty_cache()
    return rows


def reset_counts() -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS

    VS.veb_walk_fused.launches = 0
    VS.veb_walk_rows.launches = 0
    ref.ref_delta_walk_fused.calls = 0
    ref.ref_veb_walk_rows.calls = 0


def read_counts() -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS

    return dict(fused=VS.veb_walk_fused.launches,
                rows=VS.veb_walk_rows.launches,
                plain=ref.ref_delta_walk_fused.calls
                + ref.ref_veb_walk_rows.calls)


def main_path(keys, rng, device, steps: int, walk_fused: bool) -> dict:
    """Phase 3: Fig. 12's concurrency-1024 mix through the Index API."""
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
    return dict(walk_fused=walk_fused, keys=int(keys.size),
                max_dnodes=ix.cfg.max_dnodes, arena_mb=arena / 1e6,
                build_s=build_s, steps=steps, counts=counts,
                search_ms=statistics.median(search_s[1:] or search_s) * 1e3,
                update_ms=statistics.median(update_s[1:] or update_s) * 1e3,
                mean_hops=statistics.fmean(hops), size=ix.size())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    card, kind = card_check()
    device = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    keys = np.unique(rng.integers(1, KEY_MAX, INITIAL).astype(np.int32))
    log(f"Fig. 12 tree: {keys.size} keys, {fig12_config(keys.size)}")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)

    kern = compare_kernels(keys, rng, device, flush)

    fused_run = main_path(keys, rng, device, STEPS, walk_fused=True)
    log(json.dumps({"main_path": fused_run}))
    c = fused_run["counts"]
    check(c["fused"] > 0, "the main path did not launch veb_walk_fused")
    check(c["plain"] == 0, "the main path ran a plain walk version")
    round_run = main_path(keys, rng, device, PER_ROUND_STEPS,
                          walk_fused=False)
    log(json.dumps({"main_path": round_run}))
    c = round_run["counts"]
    check(c["rows"] > 0, "the per-round path did not launch veb_walk_rows")
    check(c["fused"] == 0 and c["plain"] == 0,
          "the per-round path ran another walk")

    replaces = {"fused": "src/repro/kernels/veb_search.py:228",
                "rows": "src/repro/kernels/veb_search.py:93"}
    launches = {"fused": fused_run["counts"]["fused"],
                "rows": round_run["counts"]["rows"]}
    out = []
    for name in ("fused", "rows"):
        r = kern[name]
        out.append({"name": f"veb_walk_{name}", "route": "cuda",
                    "source": SOURCE, "replaces": replaces[name],
                    "launches": launches[name], "max_abs_err": r["err"],
                    "exact": r["err"] == 0, "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": "bytes", "library_ms": None,
                    "searchsorted_ms": r["searchsorted_ms"], "K": BATCH})
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
