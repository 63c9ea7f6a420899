#!/usr/bin/env python3
"""Block-size sweep of the walk kernels, beside other checkouts', on one card.

    python3 tools/walk_sweep.py [--base DIR ...] [--threads 32,64,128,256]
                                [--reps 20] [--seed 0] [--out FILE]

Builds ``csrc/veb_walk.cu`` once for each block size in ``--threads`` (a
copy of the source under ``build/walk_sweep/`` with ``kThreads`` set to
it; the source in the checkout is not touched) and, with ``--base``, each
DIR's ``veb_walk.cu`` as it is, named by DIR's last component (DIR is
another checkout's root, for instance the parent commit unpacked with
``git archive`` into the git-ignored ``build/``); one nvcc each, all at
once, with ``-Xptxas -v`` (the
register, shared-memory and spill lines of each build are printed).
Then, on ``chip_smoke.py``'s phase 2 trees (the Fig. 12 tree after three
update batches, set mode and map mode) and queries, for K = 1024 and
2**20 (``chip_smoke.TIMED_K``): every build's ``veb_walk_fused`` and
``veb_walk_rows`` (over the rows of the per-round walk's first round) must
equal the plain versions exactly, then each is timed with
``chip_smoke.cuda_ms`` (CUDA events, L2 flushed before each launch) in
turns: the bases, each size, then all again in reverse order; a build's
time is the mean of its two readings.  Prints a JSON line a cell and a
table; ``--out`` writes them all.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SWEEP_DIR = ROOT / "build" / "walk_sweep"
CSRC = Path("src/repro_torch/kernels/csrc")
KTHREADS = re.compile(r"constexpr int kThreads = \d+;")


def build(csrc: Path, name: str, threads: int | None) -> tuple[Path, str]:
    """Compiles ``csrc``'s veb_walk.cu (kThreads set to ``threads`` unless
    None) into ``build/walk_sweep/<name>/``; returns the library and
    ptxas's report."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path

    out = SWEEP_DIR / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for f in [csrc / "veb_walk.cu", *csrc.glob("*.cuh")]:
        shutil.copy(f, out / f.name)
    cu = out / "veb_walk.cu"
    if threads is not None:
        text, n = KTHREADS.subn(f"constexpr int kThreads = {threads};",
                                cu.read_text())
        if n != 1:
            raise SystemExit(f"kThreads not found once in {csrc}/veb_walk.cu")
        cu.write_text(text)
    lib = out / "veb_walk.so"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                           str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {cu}:\n{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, nargs="+", default=[],
                    help="other checkouts' roots, timed beside this one")
    ap.add_argument("--threads", default="32,64,128,256")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("walk_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.kernels import build as B
    from repro_torch.kernels import ref
    from repro_torch.kernels import veb_search as VS

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    jobs = [(d.name, d / CSRC, None) for d in args.base]
    jobs += [(f"t{n}", ROOT / CSRC, int(n)) for n in args.threads.split(",")]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build(j[1], j[0], j[2]), jobs))
    libs = {}
    for (name, _, _), (lib, report) in zip(jobs, built):
        libs[name] = ctypes.CDLL(str(lib))
        for line in CS.ptxas_lines(report, ("walk_fused_kernel",
                                            "walk_rows_kernel")):
            print(f"ptxas {name}: {line}", flush=True)
    names = list(libs)
    order = names + names[::-1]

    device = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    keys = np.unique(rng.integers(1, CS.KEY_MAX, CS.INITIAL).astype(np.int32))
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
    rows_out = []
    for bits in (0, 12):
        mode = "map int64" if bits else "set int32"
        cfg, t = CS.churned_tree(keys, bits, rng, device)
        h, cap = cfg.height, cfg.walk_round_cap
        for k in CS.TIMED_K:
            q = CS.kernel_queries(cfg, t, keys, k, rng, device)
            roots = t.root.expand(k).contiguous()
            rws, crw = t.value[roots.long()], t.child[roots.long()]
            calls = {
                "fused": lambda: VS.veb_walk_fused(t.value, t.child, roots, q,
                                                   height=h, max_rounds=cap),
                "rows": lambda: VS.veb_walk_rows(rws, crw, q, height=h),
            }
            want = {
                "fused": ref.ref_delta_walk_fused(t.value, t.child, roots, q,
                                                  height=h, max_rounds=cap),
                "rows": ref.ref_veb_walk_rows(rws, crw, q, height=h),
            }
            for kernel, fn in calls.items():
                for name in names:
                    B._LOADED["veb_walk.cu"] = libs[name]
                    got = fn()
                    torch.cuda.synchronize()
                    CS.check(all(torch.equal(a, b) for a, b in
                                 zip(got, want[kernel])),
                             f"{name} {kernel} != plain ({mode}, K={k})")
                times = {name: [] for name in names}
                for name in order:
                    B._LOADED["veb_walk.cu"] = libs[name]
                    times[name].append(CS.cuda_ms(fn, args.reps, flush))
                row = dict(mode=mode, K=k, kernel=kernel,
                           ms={n: statistics.fmean(v)
                               for n, v in times.items()},
                           readings=times)
                print(json.dumps(row), flush=True)
                rows_out.append(row)
        del t
        torch.cuda.empty_cache()
    B._LOADED.pop("veb_walk.cu", None)
    print("| mode | K | kernel | " + " | ".join(names) + " |")
    for r in rows_out:
        print(f"| {r['mode']} | {r['K']} | {r['kernel']} | "
              + " | ".join(f"{r['ms'][n]:.6f}" for n in names) + " |")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "cells": rows_out},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
