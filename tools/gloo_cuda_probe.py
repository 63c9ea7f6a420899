#!/usr/bin/env python3
"""What gloo does with CUDA tensors when R processes share one card
(``chip_smoke.py`` phases 12-13's setting): the plain c10d calls the
sharded trainer makes (`repro_torch.parallel.comm`) against DTensor's
own collectives, which it does not use.

    python3 tools/gloo_cuda_probe.py [--ranks 4] [--mb 64] [--reps 3]
                                     [--out FILE]

Three spawns of ``--ranks`` processes over a gloo group (a ``file://``
rendezvous in a temporary directory; each on card 0):

* ``direct``: each c10d collective on a CUDA tensor of ``--mb`` MB a
  rank (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_reduce``, ``all_to_all_single``, ``broadcast``, ``gather``) over
  the default group, gloo's own CUDA path: host-clocked median of
  ``--reps`` calls after an untimed one, each call ending in
  ``torch.cuda.synchronize()`` and a barrier before it;
* ``port``: ``parallel.comm``'s ``all_gather`` / ``reduce_scatter`` /
  ``all_reduce`` / ``gather`` on the same tensors, over the groups of a
  CUDA ("data", "model") = (2, R / 2) mesh as the trainer calls them
  (all-gather over "data", reduce-scatter and max over "model", sum
  over each, gather over the default group); each result checked
  against the value it must have;
* ``dtensor``: DTensor's own redistribution (Shard -> Replicate over
  "data", its functional all-gather) of a (256, 512) float32 tensor on a
  CUDA ``DeviceMesh`` (2, R / 2) over gloo.  Run last and alone: it
  crashed the process with torch 2.11 (SIGSEGV), which is reported as
  the exit signal, not raised.

Prints one JSON line a spawn (rank 0's timings, the exit state), the
card's name and power limit and torch's version; ``--out`` writes them.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _child(rank: int, world: int, store: str, kind: str, mb: int,
           reps: int, out: str) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda")
    res: dict = {}
    try:
        if kind == "dtensor":
            from torch.distributed.device_mesh import DeviceMesh
            from torch.distributed.tensor import (
                Replicate,
                Shard,
                distribute_tensor,
            )

            mesh = DeviceMesh("cuda", torch.arange(world).reshape(
                2, world // 2), mesh_dim_names=("data", "model"))
            w = torch.randn(256, 512, device=dev)
            d = distribute_tensor(w, mesh, [Shard(0), Shard(1)],
                                  src_data_rank=None)
            g = d.redistribute(mesh, [Replicate(), Shard(1)])
            torch.cuda.synchronize()
            res["dtensor_all_gather"] = list(g.to_local().shape)
        else:
            from repro_torch.launch.mesh import make_host_mesh
            from repro_torch.parallel import comm as C

            n = mb * 2 ** 20 // 4
            x = torch.ones(n, device=dev)
            big = torch.ones(n * world, device=dev)
            if kind == "direct":
                out_t = torch.empty(n * world, device=dev)
                parts = [torch.empty_like(x) for _ in range(world)]
                calls = {
                    "all_gather_into_tensor":
                        lambda: dist.all_gather_into_tensor(out_t, x),
                    "reduce_scatter_tensor":
                        lambda: dist.reduce_scatter_tensor(x, big),
                    "all_reduce": lambda: dist.all_reduce(x),
                    "all_to_all_single":
                        lambda: dist.all_to_all_single(torch.empty_like(x), x),
                    "broadcast": lambda: dist.broadcast(x, 0),
                    "gather": lambda: dist.gather(
                        x, parts if rank == 0 else None, dst=0),
                }
            else:
                mesh = make_host_mesh(2, world // 2, device=dev)
                data, model = mesh.get_group(0), mesh.get_group(1)
                nd, nm = 2, world // 2
                y = torch.full((n,), float(rank), device=dev)
                ag = C.all_gather(y, data)
                rows = [r * nm + mesh.get_local_rank(1) for r in range(nd)]
                want = torch.tensor(rows, device=dev).float()
                ok = bool((ag.view(nd, n) == want[:, None]).all())
                rs = C.reduce_scatter(big, model)
                ok &= bool((rs == nm).all()) and rs.shape[0] == n * world // nm
                mx = C.all_reduce(y, model, "max")
                ok &= bool((mx == float(mesh.get_local_rank(0) * nm + nm - 1)
                            ).all())
                sm = C.all_reduce(x, data)
                ok &= bool((sm == nd).all()) and bool((x == 1).all())
                got = C.gather(y)
                if rank == 0:
                    ok &= all(bool((g == r).all()) and g.is_cuda
                              for r, g in enumerate(got))
                res["checked"] = ok
                calls = {"all_gather": lambda: C.all_gather(x, data),
                         "reduce_scatter": lambda: C.reduce_scatter(big,
                                                                    model),
                         "all_reduce": lambda: C.all_reduce(x, model),
                         "gather": lambda: C.gather(x)}
            for name, fn in calls.items():
                ms = []
                for i in range(reps + 1):
                    torch.cuda.synchronize()
                    dist.barrier()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    if i:
                        ms.append((time.perf_counter() - t0) * 1e3)
                res[f"{name}_ms"] = statistics.median(ms)
        if rank == 0:
            Path(out).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def spawn(kind: str, world: int, mb: int, reps: int) -> dict:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/out.json"
        t0 = time.perf_counter()
        ctx = mp.start_processes(_child, args=(world, f"{tmp}/store", kind,
                                               mb, reps, out),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        state = "ok"
        try:
            while not ctx.join(timeout=1):
                if time.perf_counter() - t0 > 600:
                    state = "timeout"
                    break
        except Exception as e:       # a rank died: report how
            state = f"failed: {str(e).strip().splitlines()[0]}"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(5)
        res = json.loads(Path(out).read_text()) if Path(out).exists() else {}
    return {"kind": kind, "ranks": world, "mb": mb, "state": state, **res}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--mb", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rows = []
    for kind in ("direct", "port", "dtensor"):
        row = dict(spawn(kind, args.ranks, args.mb, args.reps), card=card,
                   torch=torch.__version__)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out is not None:
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
