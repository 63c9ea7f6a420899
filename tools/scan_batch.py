#!/usr/bin/env python3
"""Scan and main-path batch times of two checkouts of the port on one
card, in one run.

    python3 tools/scan_batch.py --base DIR [--pairs 2] [--reps 30] [--seed 0]
                                [--out FILE]

DIR is another checkout's root (for instance the parent commit unpacked
with ``git archive`` into the git-ignored ``build/``); its ``src`` holds
the port to compare with this checkout's.  Each version runs in its own
process, ``--pairs`` pairs of them with the first of a pair alternating
(base, this, this, base, ...), so that a drift of the host's speed
during the run falls on both alike.  A process builds its
checkout's kernels, then ``chip_smoke.py``'s phase 3 index (the Fig. 12
tree and its 20 update steps, same seed, so the same tree in every
process), and times on the host clock, to the end of the work on the
card:

* the scan path's batches: K = 512 bands for each (density, ``max_out``)
  cell and a 1024-key ``successor_k(keys, 16)`` batch, ``--reps`` rounds
  over the cells in turn after two untimed rounds, fresh bands each round
  (the same bands in every process), every batch checked against the
  oracle;
* ``range_scan`` pages: three paginations to the end, as phase 3 reads;
* phase 4's deferred scan batch (dense / 128 with the buffered merge,
  ``chip_smoke.relaxed_path``'s median over its 10 steps) and update
  batch;
* phase 3's search and update batches (``chip_smoke.main_path``'s medians
  over its 20 fused steps and its 3 per-round steps), which resolve the
  walks' block size on every walk.

Prints one JSON line a process, a table of their medians and, for each
time, the medians over each version's processes, the base's spread
(the distance between its quartiles) and the pairs this checkout won;
``--out`` writes them all.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def child(src: Path, reps: int, seed: int, device: str = "cuda") -> dict:
    """One process: the times of the port under ``src``."""
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as CS
    import repro_torch
    from repro_torch.core.layout import KEY_MAX as DOMAIN_MAX

    assert Path(repro_torch.__file__).resolve().is_relative_to(src.resolve())
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, CS.KEY_MAX, CS.INITIAL).astype(np.int32))
    fused, ix, oracle = CS.main_path(keys, rng, device, CS.STEPS,
                                     walk_fused=True)
    live = oracle.keys()
    cells = [(d, m) for d in CS.DENSITY_FILL for m in CS.SCAN_MAX_OUT]
    batch_ms = {f"{d}/{m}": [] for d, m in cells}
    batch_ms["successor_k/16"] = []
    band_rng = np.random.default_rng(seed + 1)
    CS.reset_counts()
    for rep in range(reps + 2):
        for density, max_out in cells:
            st, hi = CS.scan_bands(band_rng, live.size, CS.SCAN_K, density,
                                   max_out)
            res, sec = CS.timed(lambda: ix.spec.backend.scan(
                ix.cfg, ix.state, st, hi, max_out))
            CS.check_scan(res, live, st, hi, max_out, f"{density} {max_out}")
            if rep >= 2:
                batch_ms[f"{density}/{max_out}"].append(sec * 1e3)
        q = band_rng.integers(0, CS.KEY_MAX + 1000, CS.BATCH).astype(np.int32)
        res, sec = CS.timed(lambda: ix.successor_k(q, 16))
        CS.check_scan(res, live, q, np.full_like(q, DOMAIN_MAX), 16,
                      "successor_k")
        if rep >= 2:
            batch_ms["successor_k/16"].append(sec * 1e3)
    page_ms = []
    for _ in range(3):
        width = int(CS.KEY_MAX / live.size * 1000)
        lo = int(band_rng.integers(1, CS.KEY_MAX - width))
        got, cursor = [], None
        while True:
            res, sec = CS.timed(lambda: ix.range_scan(lo, lo + width,
                                                      cursor=cursor))
            page_ms.append(sec * 1e3)
            got.extend(res.keys.tolist())
            if res.cursor is None:
                break
            cursor = res.cursor
        want = live[(live >= lo) & (live <= lo + width)]
        CS.check(got == want.tolist(), "range_scan pages differ")
    counts = CS.read_counts()
    CS.check(counts["scan"] > 0 and counts["plain"] == 0,
             "the scans did not all run the scan kernel")
    del ix, oracle
    torch.cuda.empty_cache()
    deferred = CS.relaxed_path(keys, rng, device, "deferred",
                               CS.DEFERRED_STEPS)
    torch.cuda.empty_cache()
    per_round, ix, _ = CS.main_path(keys, rng, device, CS.PER_ROUND_STEPS,
                                    walk_fused=False)
    del ix
    main_ms = {f"{name} {kind}": run[f"{kind}_ms"]
               for name, run in (("fused", fused), ("per-round", per_round))
               for kind in ("search", "update")}
    main_ms["deferred update"] = deferred["update_ms"]
    return dict(src=str(src), reps=reps, main_ms=main_ms,
                batch_ms={c: statistics.median(v) for c, v in batch_ms.items()},
                batch_min_ms={c: min(v) for c, v in batch_ms.items()},
                page_ms=statistics.median(page_ms), pages=len(page_ms),
                deferred_scan_ms=deferred["scan_ms"], scan_launches=counts["scan"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--child", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child, args.reps, args.seed)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or args.base is None:
        print("scan_batch: needs a CUDA card and --base", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    order = [("base", args.base / "src"), ("this", ROOT / "src")]
    runs = []
    for name, src in (order[(i + j) % 2] for i in range(args.pairs)
                      for j in range(2)):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, __file__, "--child", str(src),
                              "--reps", str(args.reps), "--seed",
                              str(args.seed)], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        row = dict(json.loads(out.stdout.strip().splitlines()[-1]),
                   version=name, seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
        runs.append(row)
    cols = [*runs[0]["batch_ms"], "page", "deferred dense/128",
            *runs[0]["main_ms"]]
    for r in runs:
        r["times"] = dict(zip(cols, [*r["batch_ms"].values(), r["page_ms"],
                                     r["deferred_scan_ms"],
                                     *r["main_ms"].values()]))
    print("| run | " + " | ".join(cols) + " |")
    for i, r in enumerate(runs):
        print(f"| {i + 1} {r['version']} | "
              + " | ".join(f"{v:.4f}" for v in r["times"].values()) + " |")
    summary = {}
    for c in cols:
        base = [r["times"][c] for r in runs if r["version"] == "base"]
        this = [r["times"][c] for r in runs if r["version"] == "this"]
        q = statistics.quantiles(base, n=4) if len(base) > 1 else [0, 0, 0]
        summary[c] = dict(base_ms=statistics.median(base),
                          this_ms=statistics.median(this),
                          base_spread_ms=q[2] - q[0],
                          pairs_won=sum(t < b for b, t in zip(base, this)),
                          pairs=len(base))
        print(json.dumps({"summary": c, **summary[c]}))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs,
                                        "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
