"""PyTorch port: the DeltaForest spread over ``torch.distributed`` ranks
equals the single-process port and the JAX forest bit for bit (the
counterparts of the JAX tests that run on 8 fake host devices).

Two gloo groups of CPU ranks are spawned once per test run each
(`_torch_ranks.spawn_ranks`, shared by the xdist workers): 8 ranks (the
JAX tests' 8 devices: S = 4 on a 4-rank mesh with replicas, S = 8 on all
8) and 4 ranks (S = 4 one shard a rank, S = 8 two).  Every rank runs the
legs of its world size and records its results and *its own* shards'
arenas; the same legs run in the test process with no group.  Each test
holds every rank's record to the single-process one key by key (dtypes
included, and each rank holds exactly its mesh position's shards), and
the single-process one to the JAX package's single-device forest: reads
(lookup in set and int64 map mode, successor, scan, ``successor_k``)
through the fused frontier and the dense dispatch, update results and
stats, every arena after every batch, ``deferred`` + ``flush``,
``rebalance``, the live set and the sharded pager's block tables.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import _torch_ranks as TR
from _torch_parity import (
    FOREST_KEY_HI, FOREST_STEPS, forest_cfgs, forest_record,
    few_jax_executables,  # noqa: F401  (autouse)
    jax_forest_shared, jax_sharded, prefixed, shared_npz,
)

_SHARD = re.compile(r"/shard(\d+)/")


def _ranks(tmp_path_factory, world: int) -> list:
    """Every rank's record of `_torch_ranks.run_legs(world)` (one spawn a
    test run)."""
    def make(path):
        recs = TR.spawn_ranks(world, Path(f"{path}.d"))
        np.savez(path, **{f"r{r}/{k}": v for r, rec in enumerate(recs)
                          for k, v in rec.items()})

    rec = shared_npz(tmp_path_factory, f"torch_ranks_{world}", make)
    return [prefixed(rec, f"r{r}") for r in range(world)]


def _single(tmp_path_factory, world: int) -> dict:
    """The same legs with no process group: the single-process port."""
    return shared_npz(tmp_path_factory, f"torch_ranks_single_{world}",
                      lambda path: np.savez(path, **TR.run_legs(world)))


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    return _ranks(tmp_path_factory, 8), _single(tmp_path_factory, 8)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _ranks(tmp_path_factory, 4), _single(tmp_path_factory, 4)


def _same(a, b, where) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=where)


def _ranks_equal(recs, rec0, prefix: str, num_shards: int) -> None:
    """Every rank recorded exactly the single-process keys under
    ``prefix`` but other positions' shards, each equal bit for bit."""
    world = len(recs)
    r = max(d for d in range(1, min(world, num_shards) + 1)
            if num_shards % d == 0)
    local = num_shards // r
    keys = [k for k in rec0 if k.startswith(prefix + "/")]
    assert keys, prefix
    for rank, rec in enumerate(recs):
        lo = (rank % r) * local
        want = {k for k in keys if (m := _SHARD.search(k)) is None
                or lo <= int(m[1]) < lo + local}
        assert {k for k in rec if k.startswith(prefix + "/")} == want, rank
        for k in want:
            _same(rec[k], rec0[k], f"rank {rank}: {k}")


def _forest_equal(jrec: dict, rec0: dict, jpre: str, pre: str,
                  num_shards: int) -> None:
    """A JAX forest recorded by `_torch_parity.forest_record` under
    ``jpre`` equals the port's `_torch_ranks.forest_state` under ``pre``:
    every shard's 16 arrays, the splits and the counters."""
    trees = prefixed(jrec, f"{jpre}/trees")
    assert trees
    for g in range(num_shards):
        for k, v in trees.items():
            _same(v[g], rec0[f"{pre}/shard{g}/{k}"], f"{pre} shard {g} {k}")
    for k in ("splits", "reads", "updates"):
        np.testing.assert_array_equal(jrec[f"{jpre}/{k}"], rec0[f"{pre}/{k}"],
                                      err_msg=f"{pre}: {k}")


def _jax_forest(f) -> dict:
    """A JAX forest's arrays as `_torch_parity.forest_record` records
    them, under ``f/``."""
    rec: dict = {}
    forest_record(rec, "f", f)
    return rec


def _trace_equal(jrec: dict, rec0: dict, prefix: str, num_shards: int,
                 engines) -> None:
    """A `_torch_ranks.trace_leg` record equals `jax_forest_leg`'s: each
    engine's reads JAX's fused reads, results, stats, arenas per step."""
    for i in range(FOREST_STEPS):
        for eng in engines:
            for read, names in TR.READS.items():
                for name in names:
                    want = jrec[f"{i}/{read}/{name}"]
                    if read in ("scan", "succk") and name in ("n", "hops"):
                        # JAX sums them with jnp.sum, which x64 widens to
                        # int64; the contract (and JAX without x64) is int32
                        want = want.astype(np.int32)
                    _same(want, rec0[f"{prefix}/{i}/{eng}/{read}/{name}"],
                          f"{prefix} step {i} {eng} {read} {name}")
        _same(jrec[f"{i}/res"], rec0[f"{prefix}/{i}/res"], f"{prefix} {i}")
        np.testing.assert_array_equal(jrec[f"{i}/stats"],
                                      rec0[f"{prefix}/{i}/stats"])
        _forest_equal(jrec, rec0, f"{i}/forest", f"{prefix}/{i}/forest",
                      num_shards)


def _live_ok(rec0: dict, pre: str) -> None:
    """The recorded live set is the arenas' (sorted, no alloc failure)."""
    live = rec0[f"{pre}/live"]
    assert (np.diff(live[:, 0]) > 0).all() and not rec0[f"{pre}/alloc_failed"]


# ------------------------------------------------------------- 8 ranks ---


def test_forest_shard_map_8_devices(ranks8):
    """test_forest.py's 8-device shard_map trace (S = 4: a 4-rank mesh,
    ranks 4-7 replicas) through the dense dispatch and the fused
    frontier: every rank = the single process = the JAX forest = the set
    oracle."""
    import jax.numpy as jnp
    from repro.core import TreeConfig
    from repro.core.oracle import SetOracle
    from repro.distributed import forest as JF

    recs, rec0 = ranks8
    _ranks_equal(recs, rec0, "smap", TR.SMAP["num_shards"])
    fcfg = JF.ForestConfig(num_shards=TR.SMAP["num_shards"],
                           tree=TreeConfig(**TR.SMAP_TREE),
                           key_max=TR.SMAP["key_max"])
    f = JF.empty(fcfg)
    oracle = SetOracle()
    rng = np.random.default_rng(TR.SMAP["seed"])
    for step in range(TR.SMAP["steps"]):
        kinds = rng.integers(1, 3, size=16).astype(np.int32)
        keys = rng.integers(1, 250, size=16).astype(np.int32)
        found, hops = JF.search_batch(fcfg, f, jnp.asarray(keys))
        np.testing.assert_array_equal(found, oracle.snapshot_search(keys))
        for eng in ("scalar", "fused"):
            _same(np.asarray(found), rec0[f"smap/{step}/{eng}/found"], step)
            _same(np.asarray(hops), rec0[f"smap/{step}/{eng}/hops"], step)
        f, res, st = JF.update_batch(fcfg, f, jnp.asarray(kinds),
                                     jnp.asarray(keys))
        np.testing.assert_array_equal(res, oracle.apply_updates(kinds, keys))
        _same(np.asarray(res), rec0[f"smap/{step}/res"], step)
        np.testing.assert_array_equal(list(st.asdict().values()),
                                      rec0[f"smap/{step}/stats"])
        _same(JF.live_keys(fcfg, f), rec0[f"smap/{step}/live"], step)
        _same(oracle.keys().astype(np.int64), rec0[f"smap/{step}/live"],
              step)
    q = rng.integers(0, 320, size=32).astype(np.int32)
    sf, sv = JF.successor_jit(fcfg, f, jnp.asarray(q))
    for eng in ("scalar", "fused"):
        _same(np.asarray(sf), rec0[f"smap/succ/{eng}/found"], eng)
        _same(np.asarray(sv), rec0[f"smap/succ/{eng}/succ"], eng)
    _forest_equal(_jax_forest(f), rec0, "f", "smap/forest",
                  TR.SMAP["num_shards"])
    _live_ok(rec0, "smap/forest")


@pytest.mark.parametrize("num_shards", [4, 8])
def test_fused_shard_map_8_devices(tmp_path_factory, ranks8, num_shards):
    """test_fused_forest.py's 8-device test: on 8 ranks the fused frontier
    (rank-dense (R, K) lanes, each rank fusing its shards), the dense
    dispatch and the scalar engine give JAX's fused reads; updates, stats
    and every arena equal JAX's after every batch."""
    recs, rec0 = ranks8
    prefix = f"fused{num_shards}"
    _ranks_equal(recs, rec0, prefix, num_shards)
    jrec = jax_forest_shared(tmp_path_factory, num_shards, "eager", 0)
    _trace_equal(jrec, rec0, prefix, num_shards, ("fused", "dense", "scalar"))
    _live_ok(rec0, f"{prefix}/{FOREST_STEPS - 1}/forest")


def test_forest_mesh_tracks_device_count(ranks8):
    """`router.forest_mesh` on 8 ranks: S = 4 gets a 4-rank "shards" mesh,
    cached; with the world size read as 1 a fresh size-1 mesh, and the
    original again after; the largest divisor of S that fits 8 ranks at
    each S, as the mesh's size and as `router.span`'s R (1 with the world
    size read as 1); the ("data", "model") host mesh.  With no group every mesh
    has one rank."""
    recs, rec0 = ranks8
    for rec in recs:
        np.testing.assert_array_equal(rec["rank/mesh"],
                                      [4, True, 1, False, True, True])
        np.testing.assert_array_equal(rec["rank/mesh_sizes"],
                                      [1, 2, 3, 4, 6, 8, 6, 8])
        np.testing.assert_array_equal(rec["rank/span_ranks"],
                                      rec["rank/mesh_sizes"])
        assert rec["rank/span_one"] == 1
        np.testing.assert_array_equal(rec["rank/host_mesh"], [2, 4])
        assert rec["rank/host_mesh_names"].tolist() == ["data", "model"]
    np.testing.assert_array_equal(rec0["rank/mesh"],
                                  [1, True, 1, True, True, True])
    assert (rec0["rank/mesh_sizes"] == 1).all()
    assert (rec0["rank/span_ranks"] == 1).all()
    np.testing.assert_array_equal(rec0["rank/host_mesh"], [1, 1])


def test_sharded_pager_x64_8_devices(tmp_path_factory, ranks8):
    """test_forest.py's sharded pager script (S = 4, int64 map mode) on 8
    ranks under the scalar and lockstep engines: block tables, stats, free
    list and every arena after every op equal the single process's and
    the JAX pager's."""
    recs, rec0 = ranks8
    jrec = jax_sharded(tmp_path_factory)
    for engine in ("scalar", "lockstep"):
        pre = f"pager/{engine}"
        _ranks_equal(recs, rec0, pre, 4)
        for i in range(3):
            _same(jrec[f"script/tables/{i}"], rec0[f"{pre}/tables/{i}"], i)
        for i in range(8):
            np.testing.assert_array_equal(jrec[f"script/{i}/stats"],
                                          rec0[f"{pre}/{i}/stats"])
            _same(jrec[f"script/{i}/free"], rec0[f"{pre}/{i}/free"], i)
            _forest_equal(jrec, rec0, f"script/{i}/forest",
                          f"{pre}/{i}/forest", 4)
        assert rec0[f"{pre}/7/forest/live"].size == 0


# ------------------------------------------------------------- 4 ranks ---


@pytest.mark.parametrize("num_shards", [4, 8])
def test_ranks_deferred_scans_and_flush(tmp_path_factory, ranks4,
                                        num_shards):
    """Deferred maintenance on 4 ranks (S = 4: a shard a rank, S = 8: two):
    lookups, successors, scans and ``successor_k`` merging each rank's
    buffered items, updates and arenas equal JAX's at every step; then a
    ``flush`` equals JAX's flush of the same forest."""
    import jax.numpy as jnp
    from repro.core.deltatree import DeltaTree
    from repro.distributed import forest as JF

    recs, rec0 = ranks4
    prefix = f"deferred{num_shards}"
    _ranks_equal(recs, rec0, prefix, num_shards)
    jrec = jax_forest_shared(tmp_path_factory, num_shards, "deferred", 0)
    _trace_equal(jrec, rec0, prefix, num_shards, ("fused", "dense"))
    # the trace leaves items buffered in several shards (so on several
    # ranks) after some batch
    assert max(sum(rec0[f"{prefix}/{i}/forest/shard{g}/bcount"].any()
                   for g in range(num_shards))
               for i in range(FOREST_STEPS)) >= 2
    last = f"{FOREST_STEPS - 1}/forest"
    fc_u, _ = forest_cfgs(num_shards, "deferred", 0, FOREST_KEY_HI, jax=True)
    f = JF.Forest(
        trees=DeltaTree(**{k: jnp.asarray(v) for k, v in
                           prefixed(jrec, f"{last}/trees").items()}),
        **{k: jnp.asarray(jrec[f"{last}/{k}"])
           for k in ("splits", "reads", "updates")},
        epoch=jnp.int32(FOREST_STEPS))
    f, st = JF.flush(fc_u, f)
    np.testing.assert_array_equal(list(st.asdict().values()),
                                  rec0[f"{prefix}/flush/stats"])
    _forest_equal(_jax_forest(f), rec0, "f", f"{prefix}/flush/forest",
                  num_shards)
    for g in range(num_shards):
        assert not rec0[f"{prefix}/flush/forest/shard{g}/bcount"].any()
    _live_ok(rec0, f"{prefix}/flush/forest")


@pytest.mark.parametrize("num_shards,policy", [(4, "eager"), (8, "deferred")])
def test_ranks_map_mode_x64(tmp_path_factory, ranks4, num_shards, policy):
    """Map mode (int64 packed values, 8 payload bits) on 4 ranks: every
    read, payloads included, updates and arenas equal the JAX forest run
    with x64; the deferred leg's flush equals the single process's."""
    recs, rec0 = ranks4
    prefix = f"map{num_shards}{policy}"
    _ranks_equal(recs, rec0, prefix, num_shards)
    jrec = jax_forest_shared(tmp_path_factory, num_shards, policy, 8)
    _trace_equal(jrec, rec0, prefix, num_shards, ("fused", "dense"))
    assert rec0[f"{prefix}/0/fused/lookup/payload"].dtype == np.int32
    end = "flush" if policy == "deferred" else FOREST_STEPS - 1
    _live_ok(rec0, f"{prefix}/{end}/forest")


@pytest.mark.parametrize("num_shards", [4, 8])
def test_ranks_rebalance(ranks4, num_shards):
    """A forest piled into its last shards trips ``needs_rebalance`` on
    every rank; ``rebalance`` gathers the live keys, and each rank builds
    its own slice of JAX's rebalanced forest."""
    from repro.core import TreeConfig
    from repro.distributed import forest as JF
    from repro.distributed import splits as JSP

    recs, rec0 = ranks4
    pre = f"rebal{num_shards}"
    _ranks_equal(recs, rec0, pre, num_shards)
    fcfg = JF.ForestConfig(num_shards=num_shards,
                           tree=TreeConfig(**TR.REBAL_TREE))
    vals = TR.rebalance_keys()
    skewed = JF.bulk_build(fcfg, vals,
                           splits=np.asarray(TR.REBAL_SKEW[num_shards]))
    fixed = JSP.rebalance(fcfg, skewed)
    np.testing.assert_array_equal(
        rec0[f"{pre}/needs"], [JSP.needs_rebalance(fcfg, skewed),
                               JSP.needs_rebalance(fcfg, fixed)])
    np.testing.assert_array_equal(rec0[f"{pre}/needs"], [True, False])
    np.testing.assert_array_equal(
        rec0[f"{pre}/counts"], [JSP.shard_counts(fcfg, skewed),
                                JSP.shard_counts(fcfg, fixed)])
    for name, jf in (("skewed", skewed), ("fixed", fixed)):
        _forest_equal(_jax_forest(jf), rec0, "f", f"{pre}/{name}",
                      num_shards)
        np.testing.assert_array_equal(rec0[f"{pre}/{name}/live"][:, 0], vals)


def test_ranks_read_stats_and_capability(ranks4):
    """A stats- and transfer-collecting S = 4 forest through the Index
    API on 4 ranks: lookups, every ``ReadStats`` field (search, router,
    transfers), ``size``, ``alloc_failed`` and ``shard_load`` equal the
    single process's under both dispatches; the capability reports 4
    ranks (1 with no group)."""
    recs, rec0 = ranks4
    _ranks_equal(recs, rec0, "stats", 4)
    for name in ("fused", "dense"):
        for step in range(2):
            for k in rec0:
                if k.startswith(f"stats/{name}/{step}/"):
                    other = k.replace(f"/{name}/", "/fused/")
                    _same(rec0[k], rec0[other], k)
        np.testing.assert_array_equal(rec0[f"stats/{name}/sharded"],
                                      [True, name == "fused"])
        for rec in recs:
            assert int(rec[f"rank/{name}/ranks"]) == 4
        assert int(rec0[f"rank/{name}/ranks"]) == 1
    assert int(rec0["stats/fused/size"]) > 600
    assert rec0["stats/fused/0/transfers/dnode_visits"] > 0


def test_no_process_group_is_one_rank(monkeypatch):
    """Without a process group the forest mesh, the host mesh and the
    span are one rank holding every shard; `forest_ranks` is the largest
    divisor of S that fits the world size; the group helper takes only a
    backend its caller names, and under nccl the card of the rank's
    local rank (the argument, else ``LOCAL_RANK``, else the rank).  A
    mesh's device is the card unless the caller names another."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import router as R
    from repro_torch.launch.mesh import (
        forest_ranks, make_forest_mesh, make_host_mesh, start_process_group,
    )

    assert [forest_ranks(s, 8) for s in (1, 3, 5, 12, 16)] == [1, 3, 5, 6, 8]
    assert [forest_ranks(8, w) for w in (1, 2, 3, 5, 7)] == [1, 2, 2, 4, 4]

    assert not dist.is_initialized()
    m = make_forest_mesh(8, device="cpu")
    assert m.size() == 1 and m.mesh_dim_names == ("shards",)
    assert m.device_type == "cpu"
    assert R.span(8) == R.Span(1, 0, 8) and R.span(8).lo == 0
    hm = make_host_mesh(device="cpu")
    assert hm.mesh_dim_names == ("data", "model")
    assert hm.device_type == "cpu"
    if not torch.cuda.is_available():
        for make in (lambda: make_forest_mesh(8), make_host_mesh):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_host_mesh(2, 1)
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        start_process_group("mpi", rank=0, world_size=1,
                            init_method="file:///nonexistent")
    with pytest.raises(ValueError, match="needs a card"):
        start_process_group("nccl", rank=0, world_size=2,
                            init_method="file:///nonexistent")
    with pytest.raises(ValueError, match="local rank 1 of 8"):
        start_process_group("nccl", rank=5, world_size=8, local_rank=1,
                            init_method="file:///nonexistent")
    monkeypatch.setenv("LOCAL_RANK", "3")
    with pytest.raises(ValueError, match="local rank 3 of 8"):
        start_process_group("nccl", rank=7, world_size=8,
                            init_method="file:///nonexistent")
    assert not dist.is_initialized()
