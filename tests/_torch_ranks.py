"""The port's DeltaForest over ``torch.distributed`` ranks, for
``tests/test_torch_forest_ranks.py``.

`spawn_ranks` starts a gloo group of CPU ranks (one process a rank,
``torch.set_num_threads(1)`` in each, a ``file://`` rendezvous under the
caller's directory, so parallel test workers never share a port); every
rank runs the legs of its world size (`LEGS`) and saves what they
recorded.  The test process runs the same legs with no group: that is the
single-process port.  Each leg fills a dict of numpy arrays under its own
prefix (arenas under their *global* shard index, so a rank records only
its own shards); the test compares each rank's dict with the
single-process one key by key, and the single-process one with the JAX
package's.  Keys under ``rank/`` differ by design (the rank count) and are
checked on their own.  This module imports torch and the port, never JAX.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from unittest import mock

import numpy as np

from _torch_parity import (
    FOREST_KEY_HI, FOREST_MAX_ITEMS, FOREST_STEPS, FOREST_SUCC_K, SCAN_COLS,
    SHARDED_PAGER, STAT_KEYS, forest_cfgs, forest_seed, forest_trace,
    run_sharded_script,
)

READS = {"lookup": ("found", "payload", "hops"), "succ": ("found", "succ"),
         "scan": SCAN_COLS, "succk": SCAN_COLS}

# test_forest.py::test_forest_shard_map_8_devices
SMAP = dict(num_shards=4, key_max=300, steps=5, seed=5)
SMAP_TREE = dict(height=4, max_dnodes=256, buf_cap=8)
# test_forest.py::test_bulk_build_equidepth_and_rebalance's forest, skewed
REBAL_TREE = dict(height=5, max_dnodes=512, buf_cap=8)
REBAL_SKEW = {4: [9990, 9994, 9997], 8: [9990, 9992, 9993, 9994, 9995,
                                        9996, 9997]}
MESH_SHARDS = (1, 2, 3, 4, 6, 8, 12, 16)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def forest_state(rec: dict, prefix: str, fcfg, f) -> None:
    """This rank's shards' 16 arena arrays under their global index, the
    replicated splits and counters, and the live items (gathered)."""
    from repro_torch.core.deltatree import to_numpy
    from repro_torch.distributed import forest as TF
    from repro_torch.distributed import router as R

    sp = R.span(fcfg.num_shards)
    for j in range(sp.local):
        for k, v in to_numpy(TF.shard_tree(f, j)).items():
            rec[f"{prefix}/shard{sp.lo + j}/{k}"] = v
    for k in ("splits", "reads", "updates"):
        rec[f"{prefix}/{k}"] = _np(getattr(f, k))
    rec[f"{prefix}/live"] = np.asarray(TF.live_items(fcfg, f),
                                       np.int64).reshape(-1, 2)
    rec[f"{prefix}/alloc_failed"] = np.asarray(TF.alloc_failed(f))


def trace_leg(rec: dict, prefix: str, num_shards: int, policy: str,
              bits: int, engines=("fused", "dense"),
              flush: bool = False) -> None:
    """`_torch_parity.forest_trace` at ``forest_seed`` through the port
    (the trace of `jax_forest_shared`): per step every read under each of
    ``engines``
    (fused lockstep, dense lockstep, dense scalar), then the update batch
    (lockstep), its results and stats and the forest; with ``flush`` a
    final `flush`."""
    from repro_torch.distributed import forest as TF

    fc_u, fc_f = forest_cfgs(num_shards, policy, bits, FOREST_KEY_HI,
                             jax=False)
    cfgs = {"fused": fc_f, "dense": dataclasses.replace(fc_f, fused=False),
            "scalar": dataclasses.replace(fc_f, tree=dataclasses.replace(
                fc_f.tree, engine="scalar"))}
    init, pays, trace = forest_trace(forest_seed(num_shards, bits),
                                     FOREST_STEPS, FOREST_KEY_HI,
                                     payload_bits=bits)
    f = TF.bulk_build(fc_u, init, pays, device="cpu")
    for i, st in enumerate(trace):
        q = st["q"]
        for eng in engines:
            fc = cfgs[eng]
            outs = {
                "lookup": TF.lookup_batch(fc, f, q),
                "succ": TF.successor_jit(fc, f, q),
                "scan": TF.scan_batch(fc, f, st["st"], st["hi"],
                                      max_items=FOREST_MAX_ITEMS),
                "succk": TF.successor_k(fc, f, q, FOREST_SUCC_K),
            }
            for read, cols in outs.items():
                for name, col in zip(READS[read], cols):
                    rec[f"{prefix}/{i}/{eng}/{read}/{name}"] = _np(col)
        f, res, stats = TF.update_batch(fc_u, f, st["kinds"], st["keys"],
                                        st["pays"])
        rec[f"{prefix}/{i}/res"] = _np(res)
        rec[f"{prefix}/{i}/stats"] = np.asarray(list(stats))
        forest_state(rec, f"{prefix}/{i}/forest", fc_u, f)
    if flush:
        f, stats = TF.flush(fc_u, f)
        rec[f"{prefix}/flush/stats"] = np.asarray(list(stats))
        forest_state(rec, f"{prefix}/flush/forest", fc_u, f)


def smap_leg(rec: dict) -> None:
    """test_forest.py::test_forest_shard_map_8_devices: S = 4 from empty,
    5 steps of a search then an update batch (the default scalar engine,
    so the dense dispatch), then 32 successors; the same reads also
    through the fused lockstep frontier."""
    from repro_torch.core.deltatree import TreeConfig
    from repro_torch.distributed import forest as TF

    fcfg = TF.ForestConfig(num_shards=SMAP["num_shards"],
                           tree=TreeConfig(**SMAP_TREE),
                           key_max=SMAP["key_max"])
    fused = dataclasses.replace(fcfg, tree=dataclasses.replace(
        fcfg.tree, engine="lockstep"))
    f = TF.empty(fcfg, device="cpu")
    rng = np.random.default_rng(SMAP["seed"])
    for step in range(SMAP["steps"]):
        kinds = rng.integers(1, 3, size=16).astype(np.int32)
        keys = rng.integers(1, 250, size=16).astype(np.int32)
        for name, fc in (("scalar", fcfg), ("fused", fused)):
            found, hops = TF.search_batch(fc, f, keys)
            rec[f"smap/{step}/{name}/found"] = _np(found)
            rec[f"smap/{step}/{name}/hops"] = _np(hops)
        f, res, stats = TF.update_batch(fcfg, f, kinds, keys)
        rec[f"smap/{step}/res"] = _np(res)
        rec[f"smap/{step}/stats"] = np.asarray(list(stats))
        rec[f"smap/{step}/live"] = TF.live_keys(fcfg, f)
    q = rng.integers(0, 320, size=32).astype(np.int32)
    for name, fc in (("scalar", fcfg), ("fused", fused)):
        sf, sv = TF.successor_jit(fc, f, q)
        rec[f"smap/succ/{name}/found"] = _np(sf)
        rec[f"smap/succ/{name}/succ"] = _np(sv)
    forest_state(rec, "smap/forest", fcfg, f)


def mesh_leg(rec: dict) -> None:
    """test_forest.py::test_forest_mesh_tracks_device_count: the cached
    mesh follows the world size; the mesh size and `router.span`'s R at
    each of ``MESH_SHARDS``; the host mesh."""
    import torch.distributed as dist

    from repro_torch.distributed import router as R
    from repro_torch.launch.mesh import make_forest_mesh, make_host_mesh

    m4 = R.forest_mesh(4, "cpu")
    with mock.patch.object(dist, "get_world_size", return_value=1):
        m1 = R.forest_mesh(4, "cpu")
    rec["rank/mesh"] = np.asarray(
        [m4.size(), R.forest_mesh(4, "cpu") is m4, m1.size(), m1 is m4,
         R.forest_mesh(4, "cpu") is m4, m4.mesh_dim_names == ("shards",)])
    rec["rank/mesh_sizes"] = np.asarray([make_forest_mesh(
        s, device="cpu").size() for s in MESH_SHARDS])
    rec["rank/span_ranks"] = np.asarray([R.span(s).ranks
                                         for s in MESH_SHARDS])
    with mock.patch.object(dist, "get_world_size", return_value=1):
        rec["rank/span_one"] = np.asarray(R.span(4).ranks)
    w = dist.get_world_size() if dist.is_initialized() else 1
    hm = (make_host_mesh(2, w // 2, device="cpu") if w > 1
          else make_host_mesh(device="cpu"))
    rec["rank/host_mesh"] = np.asarray(list(hm.shape))
    rec["rank/host_mesh_names"] = np.asarray(hm.mesh_dim_names)


def pager_leg(rec: dict) -> None:
    """test_forest.py::test_sharded_pager_x64_8_devices's script on
    ``ShardedPagerConfig(**SHARDED_PAGER)`` under both engines: block
    tables, and after every op the pager's stats, free list and forest."""
    from repro_torch.serving import ShardedDeltaPager, ShardedPagerConfig

    for engine in ("scalar", "lockstep"):
        pg = ShardedDeltaPager(ShardedPagerConfig(**SHARDED_PAGER,
                                                  engine=engine),
                               device="cpu")
        pre = f"pager/{engine}"

        def state(i, p, pre=pre):
            rec[f"{pre}/{i}/stats"] = np.asarray([p.stats[k]
                                                  for k in STAT_KEYS])
            rec[f"{pre}/{i}/free"] = np.asarray(p.free_pages, np.int64)
            forest_state(rec, f"{pre}/{i}/forest", p.index.cfg,
                         p.index.state)

        for i, t in enumerate(run_sharded_script(pg, state)):
            rec[f"{pre}/tables/{i}"] = t


def rebalance_leg(rec: dict, num_shards: int) -> None:
    """A forest built with its keys piled into the last shard:
    ``needs_rebalance`` trips, ``rebalance`` rebuilds it equi-depth over
    the live keys gathered from every rank, and each rank keeps its
    slice."""
    from repro_torch.core.deltatree import TreeConfig
    from repro_torch.distributed import forest as TF
    from repro_torch.distributed import splits as SP

    fcfg = TF.ForestConfig(num_shards=num_shards,
                           tree=TreeConfig(**REBAL_TREE))
    vals = rebalance_keys()
    skewed = TF.bulk_build(fcfg, vals, splits=REBAL_SKEW[num_shards],
                           device="cpu")
    fixed = SP.rebalance(fcfg, skewed)
    pre = f"rebal{num_shards}"
    rec[f"{pre}/needs"] = np.asarray([SP.needs_rebalance(fcfg, skewed),
                                      SP.needs_rebalance(fcfg, fixed)])
    rec[f"{pre}/counts"] = np.stack([SP.shard_counts(fcfg, skewed),
                                     SP.shard_counts(fcfg, fixed)])
    forest_state(rec, f"{pre}/skewed", fcfg, skewed)
    forest_state(rec, f"{pre}/fixed", fcfg, fixed)


def rebalance_keys() -> np.ndarray:
    rng = np.random.default_rng(4)
    return np.unique(rng.integers(1, 10_000, size=2000).astype(np.int32))


def stats_leg(rec: dict) -> None:
    """An S = 4 forest through the Index API collecting read stats and
    transfers: lookups through both dispatches with their ``ReadStats``,
    ``size``, ``alloc_failed``, ``shard_load`` and the capability."""
    from repro_torch.api import Index, OpBatch, make_index
    from repro_torch.distributed import forest as TF

    init = np.unique(np.random.default_rng(17).integers(1, 5000, 600)
                     ).astype(np.int32)
    kw = dict(initial=init, payloads=init % 251, num_shards=4, height=4,
              max_dnodes=256, buf_cap=8, key_max=5000, payload_bits=8,
              engine="lockstep", maintenance="deferred",
              collect_stats=True, collect_transfers=True, device="cpu")
    for name, fused in (("fused", True), ("dense", False)):
        rng = np.random.default_rng(18)
        ix = make_index("forest", fused=fused, **kw)
        for step in range(2):
            q = rng.integers(0, 5100, 77).astype(np.int32)
            found, pay, hops, st = ix.lookup(q)
            pre = f"stats/{name}/{step}"
            rec[f"{pre}/found"], rec[f"{pre}/payload"] = _np(found), _np(pay)
            rec[f"{pre}/hops"] = _np(hops)
            for leg in ("search", "router", "transfers"):
                for k, v in getattr(st, leg)._asdict().items():
                    rec[f"{pre}/{leg}/{k}"] = _np(v)
            ix = Index(ix.spec, TF.record_reads(ix.cfg, ix.state, q))
            keys = rng.integers(1, 5000, 40).astype(np.int32)
            ix, _ = ix.insert_delete(OpBatch.inserts(keys, keys % 251))
        cap = ix.capability
        rec[f"stats/{name}/size"] = np.asarray(ix.size())
        rec[f"stats/{name}/alloc_failed"] = np.asarray(ix.alloc_failed())
        rec[f"stats/{name}/load"] = np.asarray(list(
            TF.shard_load(ix.state).values()))
        rec[f"stats/{name}/sharded"] = np.asarray([cap.sharded,
                                                   cap.fused_forest])
        rec[f"rank/{name}/ranks"] = np.asarray(cap.ranks)


LEGS = {
    # the JAX package's fake-device tests (8 devices) and the pager
    8: (smap_leg, mesh_leg, pager_leg,
        lambda rec: trace_leg(rec, "fused4", 4, "eager", 0,
                              engines=("fused", "dense", "scalar")),
        lambda rec: trace_leg(rec, "fused8", 8, "eager", 0,
                              engines=("fused", "dense", "scalar"))),
    # 4 ranks: S = 4 one shard a rank, S = 8 two; deferred + flush in set
    # mode, both policies in map mode, rebalance, stats and capability
    4: (lambda rec: trace_leg(rec, "deferred4", 4, "deferred", 0,
                              flush=True),
        lambda rec: trace_leg(rec, "deferred8", 8, "deferred", 0,
                              flush=True),
        lambda rec: trace_leg(rec, "map4eager", 4, "eager", 8),
        lambda rec: trace_leg(rec, "map8deferred", 8, "deferred", 8,
                              flush=True),
        lambda rec: rebalance_leg(rec, 4), lambda rec: rebalance_leg(rec, 8),
        stats_leg),
}


def run_legs(world: int) -> dict:
    """Every leg of world size ``world``, in order; returns the record."""
    rec: dict = {}
    for leg in LEGS[world]:
        leg(rec)
    return rec


def _rank_main(rank: int, world: int, out_dir: str, legs) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import start_process_group

    torch.set_num_threads(1)
    start_process_group("gloo", rank=rank, world_size=world,
                        init_method=f"file://{out_dir}/store")
    try:
        t0 = time.perf_counter()
        rec = legs(world, out_dir)
        rec["rank/seconds"] = np.asarray(time.perf_counter() - t0)
        np.savez(f"{out_dir}/rank{rank}.npz", **rec)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _forest_legs(world: int, out_dir: str) -> dict:
    return run_legs(world)


def spawn_ranks(world: int, out_dir: Path, timeout: float = 600,
                legs=_forest_legs) -> list:
    """Run ``legs(world, out_dir)`` (a module-level function returning a
    dict of arrays; by default `run_legs(world)`) on ``world`` gloo ranks;
    returns each rank's record.  A rank that raises, or a run past
    ``timeout`` seconds, fails (every rank is stopped)."""
    import torch.multiprocessing as mp

    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(world, str(out_dir), legs),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(5)
    out = []
    for r in range(world):
        with np.load(out_dir / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
        os.remove(out_dir / f"rank{r}.npz")
    return out
