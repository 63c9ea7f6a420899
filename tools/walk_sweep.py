#!/usr/bin/env python3
"""Block-size sweep of the walk kernels, beside other checkouts', on one card.

    python3 tools/walk_sweep.py [--base DIR ...] [--threads 32,64,128,256]
                                [--height H ...] [--reps 20] [--seed 0]
                                [--out FILE]

The walk kernels (``csrc/veb_walk.cu``) are built for each block size in
``veb_search.BLOCK_SIZES`` and take the size at launch (``q_tile``): this
checkout's library is built once and each size in ``--threads`` is timed
through ``q_tile=``.  With ``--base``, each DIR's ``veb_walk.cu`` is built
as it is (under ``build/walk_sweep/``, named by DIR's last component) and
timed at its default size; DIR is another checkout's root, for instance
the parent commit unpacked with ``git archive`` into the git-ignored
``build/``; it must take the block size at launch.  One nvcc each, all
at once, with ``-Xptxas -v`` (the register, shared-memory and spill lines
of each build are printed).  Then, on ``chip_smoke.py``'s phase 2 trees
(the Fig. 12 tree after three update batches, set mode and map mode) and
queries, for K = 1024 and 2**20 (``chip_smoke.TIMED_K``): every variant's
``veb_walk_fused`` and ``veb_walk_rows`` (over the rows of the per-round
walk's first round) must equal the plain versions exactly, then each is
timed with ``chip_smoke.cuda_ms`` (CUDA events, L2 flushed before each
launch) in turns: the bases, each size, then all again in reverse order;
a variant's time is the mean of its two readings.  With ``--height``,
the trees are instead ``chip_smoke.tall_tree``'s at each height H (20,000
draws, 64 ΔNodes where ``chip_smoke.TALL_TREES`` has no entry; one eager
update batch) and only ``veb_walk_fused`` runs, every lane from the root:
a gathered row of a tall ΔNode a lane would not fit the card at 2**20.
Prints a JSON line a cell and a table; ``--out`` writes them all.  Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SWEEP_DIR = ROOT / "build" / "walk_sweep"
CSRC = Path("src/repro_torch/kernels/csrc")


def build_base(csrc: Path, name: str) -> tuple[Path, str]:
    """Compiles ``csrc``'s veb_walk.cu as it is into
    ``build/walk_sweep/<name>/``; returns the library and ptxas's report."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path

    out = SWEEP_DIR / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for f in [csrc / "veb_walk.cu", *csrc.glob("*.cuh")]:
        shutil.copy(f, out / f.name)
    lib = out / "veb_walk.so"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                           str(lib), str(out / "veb_walk.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {csrc}/veb_walk.cu:\n{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, nargs="+", default=[],
                    help="other checkouts' roots, timed beside this one")
    ap.add_argument("--threads", default="32,64,128,256",
                    help="this checkout's block sizes to time")
    ap.add_argument("--height", type=int, nargs="+", default=[],
                    help="time the fused walk on tall trees of these heights")
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

    sizes = [int(n) for n in args.threads.split(",")]
    bad = [n for n in sizes if n not in VS.BLOCK_SIZES]
    if bad:
        raise SystemExit(f"--threads {bad}: built sizes are {VS.BLOCK_SIZES}")
    card = CS.card_name()
    print(card, flush=True)
    with ThreadPoolExecutor(len(args.base) + 2) as pool:
        bases = [pool.submit(build_base, d / CSRC, d.name) for d in args.base]
        report = pool.submit(B.resource_usage, "veb_walk.cu")
        this = pool.submit(B.library, "veb_walk.cu")
        built = [(d.name, *f.result()) for d, f in zip(args.base, bases)]
        built.append(("this", None, report.result()))
        this_lib = this.result()
    for name, _, usage in built:
        for line in CS.ptxas_lines(usage, ("walk_fused_kernel",
                                           "walk_rows_kernel")):
            print(f"ptxas {name}: {line}", flush=True)
    # variant -> (library, block size)
    variants = {}
    for name, lib, _ in built[:-1]:
        variants[name] = (ctypes.CDLL(str(lib)), VS.DEFAULT_BLOCK)
    for n in sizes:
        variants[f"t{n}"] = (this_lib, n)
    names = list(variants)
    order = names + names[::-1]

    device = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    keys = np.unique(rng.integers(1, CS.KEY_MAX, CS.INITIAL).astype(np.int32))
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
    rows_out = []
    trees = [(None, bits) for bits in (0, 12)]
    if args.height:
        trees = [(h, bits) for h in args.height for bits in (0, 12)]
    for height, bits in trees:
        mode = "map int64" if bits else "set int32"
        if height is None:
            cfg, t = CS.churned_tree(keys, bits, rng, device)
            tree_keys = keys
        else:
            cfg, t, tree_keys = CS.tall_tree(
                height, bits, rng, device,
                CS.TALL_TREES.get(height, (20_000, 64)))
        h, cap = cfg.height, cfg.walk_round_cap
        for k in CS.TIMED_K:
            q = CS.kernel_queries(cfg, t, tree_keys, k, rng, device)
            roots = t.root.expand(k).contiguous()
            calls = {"fused": lambda n: VS.veb_walk_fused(
                t.value, t.child, roots, q, height=h, max_rounds=cap,
                q_tile=n)}
            want = {"fused": ref.ref_delta_walk_fused(
                t.value, t.child, roots, q, height=h, max_rounds=cap)}
            if height is None:
                rws, crw = t.value[roots.long()], t.child[roots.long()]
                calls["rows"] = lambda n: VS.veb_walk_rows(
                    rws, crw, q, height=h, q_tile=n)
                want["rows"] = ref.ref_veb_walk_rows(rws, crw, q, height=h)
            for kernel, call in calls.items():
                for name in names:
                    lib, n = variants[name]
                    B._LOADED["veb_walk.cu"] = lib
                    got = call(n)
                    torch.cuda.synchronize()
                    CS.check(all(torch.equal(a, b) for a, b in
                                 zip(got, want[kernel])),
                             f"{name} {kernel} != plain ({mode}, K={k})")
                times = {name: [] for name in names}
                for name in order:
                    lib, n = variants[name]
                    B._LOADED["veb_walk.cu"] = lib
                    times[name].append(
                        CS.cuda_ms(lambda: call(n), args.reps, flush))
                row = dict(height=h, mode=mode, K=k, kernel=kernel,
                           ms={n: statistics.fmean(v)
                               for n, v in times.items()},
                           readings=times)
                print(json.dumps(row), flush=True)
                rows_out.append(row)
        del t
        torch.cuda.empty_cache()
    B._LOADED["veb_walk.cu"] = this_lib
    print("| height | mode | K | kernel | " + " | ".join(names) + " |")
    for r in rows_out:
        print(f"| {r['height']} | {r['mode']} | {r['K']} | {r['kernel']} | "
              + " | ".join(f"{r['ms'][n]:.6f}" for n in names) + " |")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "cells": rows_out},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
