#!/usr/bin/env python3
"""Where a forest search and update batch spend their time when R
processes share one card over gloo (``chip_smoke.py`` phase 12's setting).

    python3 tools/ranks_probe.py [--ranks 1 2 4] [--reps 100] [--seed 0]
                                 [--out FILE]

For each R in ``--ranks``, R spawned processes (R = 1: one process and
no process group) build phase 6's S = 8 forest at ``forest_scale.py
--full`` size (their S / R shards each, ``torch.set_num_threads(1)``)
and measure, in lock step (a barrier before each timed call), host-clocked
medians over ``--reps`` calls, each ending in ``torch.cuda.synchronize()``:

* ``sync_us``: a one-element add on the card, then the synchronize;
* ``gather_us``: ``router.gather_ranks`` of 1024 int32 lanes on the card
  (R > 1: the copy to the host, the gloo all-gather, the copy back);
* ``search_ms``: a fused search batch of 1024 keys (the fused view
  cached), and in one more search the host syncs (``torch.cuda``'s sync
  debug mode's warnings) and the all-gathers it makes;
* ``update_ms``: an update batch of 1024 ops at 10 % updates
  (``chip_smoke.mixed_kinds``; 20 batches), with its syncs and gathers.

Prints one JSON line per R with every rank's numbers, the card's name and
power limit (``nvidia-smi``); ``--out`` writes them all.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
UPDATE_STEPS = 20


def _counted(fn, R, torch):
    """(syncs, gathers) ``fn()`` makes: sync-debug warnings and calls of
    ``router.gather_ranks``."""
    calls = [0]
    orig = R.gather_ranks

    def gather(*a):
        calls[0] += 1
        return orig(*a)

    R.gather_ranks = gather
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        R.gather_ranks = orig
    syncs = sum("synchroniz" in str(w.message) for w in seen)
    return syncs, calls[0]


def probe(rank: int, world: int, store: str, seed: int, reps: int,
          out_dir: str) -> None:
    """One rank (or the lone process at world 1): writes its numbers to
    ``out_dir/rank{rank}.json``."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as C
    from repro_torch.api import OpBatch, make_index
    from repro_torch.distributed import router as R
    from repro_torch.launch.mesh import start_process_group

    torch.set_num_threads(1)
    if world > 1:
        start_process_group("gloo", rank=rank, world_size=world,
                            init_method=f"file://{store}")
    dev = torch.device("cuda")
    keys = np.unique(np.random.default_rng(seed + 6).integers(
        1, C.FOREST_KEY_MAX, C.FOREST_INITIAL).astype(np.int32))
    ix = make_index("forest", initial=keys, engine="lockstep", device=dev,
                    **C.forest_config(keys.size, 8))
    rng = np.random.default_rng(seed)

    def timed(fn, n):
        ts = []
        for _ in range(n):
            if world > 1:
                dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    x = torch.zeros(1, device=dev)
    row = dict(rank=rank, ranks=world,
               sync_us=timed(lambda: x.add_(1), reps) * 1e6)
    lanes = torch.arange(1024, dtype=torch.int32, device=dev)
    row["gather_us"] = (timed(lambda: R.gather_ranks(lanes, world), reps)
                        * 1e6 if world > 1 else None)
    qs = iter([rng.integers(1, C.FOREST_KEY_MAX, 1024).astype(np.int32)
               for _ in range(reps + 2)])
    ix.search(next(qs))
    row["search_ms"] = timed(lambda: ix.search(next(qs)), reps) * 1e3
    row["search_syncs"], row["search_gathers"] = _counted(
        lambda: ix.search(next(qs)), R, torch)
    batches = iter([OpBatch.mixed(C.mixed_kinds(rng, 1024, 10),
                                  rng.integers(1, C.FOREST_KEY_MAX, 1024)
                                  .astype(np.int32), device=dev)
                    for _ in range(UPDATE_STEPS + 1)])

    def update():
        nonlocal ix
        ix, _ = ix.insert_delete(next(batches))

    row["update_ms"] = timed(update, UPDATE_STEPS) * 1e3
    row["update_syncs"], row["update_gathers"] = _counted(update, R, torch)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(row))
    if world > 1:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("ranks_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as C
    from repro_torch.kernels.build import library

    card = C.card_name()
    for source in ("veb_walk.cu", "veb_scan.cu"):
        library(source)   # built once here; the ranks load it
    rows = []
    for world in args.ranks:
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(probe, args=(world, f"{tmp}/store", args.seed,
                                            args.reps, tmp),
                               nprocs=world, join=True, start_method="spawn")
            ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                     for r in range(world)]
        rows.append(dict(card=card, ranks=world, per_rank=ranks))
        print(json.dumps(rows[-1]), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
