"""PyTorch port: the DeltaForest (``repro_torch.distributed``) equals the
JAX forest (``repro.distributed``) on the CPU.

Mirrors every single-device test of ``tests/test_forest.py``: the router,
born-resolved pad lanes, multi-root walk seeding, int32 boundary keys, the
cross-shard successor fallback, equi-depth splits, a one-shard forest
against the single tree, a multi-shard forest against the single tree and
the JAX forest, bulk build + rebalance, and map mode.  After every update
batch every shard's 16 arena arrays equal the JAX forest's bit for bit,
and every shard passes the structural invariants.  Map mode runs the JAX
side with x64 in a subprocess (`_torch_parity.jax_npz`).

The JAX tests that need 8 fake devices or a device mesh
(``test_forest_shard_map_8_devices``, ``test_forest_mesh_tracks_device_
count``) have no counterpart: the port keeps every shard on one card.
"""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.distributed as JD
from repro.core import TreeConfig
from repro.core import deltatree as JDT
from repro.distributed import forest as JF
from repro.distributed import router as JR
from repro.distributed import splits as JSP
from repro_torch.core import deltatree as TDT
from repro_torch.core import layout
from repro_torch.core.oracle import SetOracle
from repro_torch.distributed import forest as TF
from repro_torch.distributed import router as TR
from repro_torch.distributed import splits as TSP

from _torch_parity import (
    assert_cols_equal, assert_forests_equal, check_invariants, jax_npz,
    few_jax_executables,  # noqa: F401  (autouse)
    np_of, port_cfg, port_fcfg, prefixed,
)

TESTS = str(Path(__file__).resolve().parent)


def _mixed_batch(rng, k, key_hi):
    kinds = rng.integers(1, 3, size=k).astype(np.int32)
    keys = rng.integers(1, key_hi, size=k).astype(np.int32)
    return kinds, keys


def _invariants(fcfg, tf, eager=True):
    for s in range(fcfg.num_shards):
        check_invariants(fcfg.tree, TF.shard_tree(tf, s),
                         require_empty_buffers=eager)


# ---------------------------------------------------------------- router ---


def test_router_roundtrip():
    """The routing plan (owner, permutation, sorted owners, lanes) equals
    JAX's; scatter / gather is an exact inverse; each dense row holds only
    its own shard's keys."""
    rng = np.random.default_rng(0)
    splits = np.asarray([50, 100, 150], np.int32)
    keys = rng.integers(1, 200, size=64).astype(np.int32)
    jr = JR.route(jnp.asarray(splits), jnp.asarray(keys))
    r = TR.route(torch.as_tensor(splits), torch.as_tensor(keys))
    assert TR.Routing._fields == JR.Routing._fields
    assert_cols_equal(jr, r, TR.Routing._fields)
    np.testing.assert_array_equal(r.sid.numpy(),
                                  TSP.shard_of_np(splits, keys))
    dense = TR.scatter_dense(r, 4, torch.as_tensor(keys), 0)
    jdense = JR.scatter_dense(jr, 4, jnp.asarray(keys), jnp.int32(0))
    np.testing.assert_array_equal(np.asarray(jdense), dense.numpy())
    back = TR.gather_batch(r, dense)
    np.testing.assert_array_equal(back.numpy(), keys)
    dense_np = dense.numpy()
    for s in range(4):
        row = dense_np[s][dense_np[s] != 0]
        assert (TSP.shard_of_np(splits, row) == s).all()
    lc = TR.lane_counts(r.sid, 4)
    np.testing.assert_array_equal(np.asarray(JR.lane_counts(jr.sid, 4)),
                                  lc.numpy())
    assert lc.dtype == torch.int32


def test_read_pads_born_resolved():
    """Dense read dispatch pads with the reserved ROUTE_LEFT key: pad lanes
    end in round 0 under the lockstep walk (0 hops, miss, no successor
    candidate), the inverse permutation never reads one, and lockstep
    per-shard hops through padded dense rows equal the scalar engine's and
    the JAX forest's."""
    from repro_torch.kernels.ops import delta_walk
    from repro_torch.kernels.veb_search import walk_big

    rng = np.random.default_rng(8)
    cfg = TDT.TreeConfig(height=4, max_dnodes=256, buf_cap=8)
    vals = np.unique(rng.integers(1, 400, 150).astype(np.int32))
    t = TDT.bulk_build(cfg, vals, device="cpu")
    q = np.concatenate([vals[:8], [layout.ROUTE_LEFT] * 5]).astype(np.int32)
    lv, _, _, hops, cand = delta_walk(t.value, t.child, t.root,
                                      torch.as_tensor(q), height=4)
    assert (hops[-5:] == 0).all() and (hops[:8] > 0).all()
    assert (lv[-5:] == 0).all()
    assert (cand[-5:] == walk_big(torch.int32)).all()
    splits = torch.as_tensor([100, 200, 300], dtype=torch.int32)
    keys = torch.as_tensor(rng.integers(1, 120, size=32), dtype=torch.int32)
    r = TR.route(splits, keys)
    dense = TR.scatter_dense(r, 4, keys, int(layout.ROUTE_LEFT))
    assert int((dense == layout.ROUTE_LEFT).sum()) == 4 * 32 - 32
    poison = torch.where(dense == layout.ROUTE_LEFT, -12345, dense)
    back = TR.gather_batch(r, poison)
    assert (back != -12345).all()
    np.testing.assert_array_equal(back.numpy(), keys.numpy())
    jt = JDT.TreeConfig(height=4, max_dnodes=256, buf_cap=8)
    q2 = rng.integers(0, 420, 64).astype(np.int32)
    jf = JF.bulk_build(JF.ForestConfig(num_shards=4, tree=jt, key_max=400,
                                       fused=False), vals)
    want = JF.search_batch(JF.ForestConfig(num_shards=4, tree=jt,
                                           key_max=400, fused=False),
                           jf, jnp.asarray(q2))
    for engine in ("lockstep", "scalar"):
        fcfg = TF.ForestConfig(num_shards=4, key_max=400, fused=False,
                               tree=TDT.TreeConfig(height=4, max_dnodes=256,
                                                   buf_cap=8, engine=engine))
        f = TF.bulk_build(fcfg, vals, device="cpu")
        got = TF.search_batch(fcfg, f, q2)
        assert_cols_equal(want, got, ("found", "hops"), engine)


def test_delta_walk_multi_root_seeding():
    """A (K,) root tensor seeds each query at its own arena root: a walk of
    the `fuse_arenas` view of two stacked arenas equals two single-root
    walks (final ΔNode ids shifted by the shard base), and the fused view
    equals the JAX one."""
    from repro.kernels.veb_search import fuse_arenas as j_fuse
    from repro_torch.kernels.ops import delta_walk
    from repro_torch.kernels.veb_search import fuse_arenas

    rng = np.random.default_rng(9)
    cfg = TDT.TreeConfig(height=4, max_dnodes=128, buf_cap=8)
    vals_a = np.unique(rng.integers(1, 500, 120).astype(np.int32))
    vals_b = np.unique(rng.integers(500, 999, 120).astype(np.int32))
    ta = TDT.bulk_build(cfg, vals_a, device="cpu")
    tb = TDT.bulk_build(cfg, vals_b, device="cpu")
    qa = rng.integers(1, 500, 40).astype(np.int32)
    qb = rng.integers(500, 999, 40).astype(np.int32)
    value = torch.stack([ta.value, tb.value])
    child = torch.stack([ta.child, tb.child])
    root = torch.stack([ta.root, tb.root])
    fv, fc, froots = fuse_arenas(value, child, root)
    assert fv.data_ptr() == value.data_ptr()       # a view, not a copy
    for a, b in zip(j_fuse(jnp.asarray(value.numpy()),
                           jnp.asarray(child.numpy()),
                           jnp.asarray(root.numpy())), (fv, fc, froots)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    lid = torch.as_tensor([0] * 40 + [1] * 40)
    q = torch.as_tensor(np.concatenate([qa, qb]))
    fused = delta_walk(fv, fc, froots[lid], q, height=4)
    ra = delta_walk(ta.value, ta.child, ta.root, torch.as_tensor(qa), height=4)
    rb = delta_walk(tb.value, tb.child, tb.root, torch.as_tensor(qb), height=4)
    m = cfg.max_dnodes
    for i, (a, b) in enumerate(zip(ra, rb)):
        one = torch.cat([a, b + m if i == 2 else b])
        assert torch.equal(fused[i], one), i


def test_forest_routes_int32_boundary_keys():
    """An out-of-int32-range probe (int64 keys) clamps — it does not wrap —
    before routing: above-domain keys route right and miss, below-domain
    keys have the global minimum as successor; updates share the boundary
    (out-of-domain rows are no-ops with result False).  The expected
    values are those of the JAX test (which needs x64)."""
    vals = np.asarray([10, 150, 250, 380], np.int32)
    hops_by_engine = {}
    for engine, fused in (("scalar", False), ("lockstep", True),
                          ("lockstep", False)):
        fcfg = TF.ForestConfig(
            num_shards=4, key_max=400, fused=fused,
            tree=TDT.TreeConfig(height=4, max_dnodes=64, buf_cap=8,
                                engine=engine))
        f = TF.bulk_build(fcfg, vals, splits=np.asarray([100, 200, 300]),
                          device="cpu")
        q = torch.as_tensor(np.array([2**31, 2**31 + 100, -5, 0, 2**31 - 2,
                                      2**40, 150], np.int64))
        sid = TR.shard_ids(f.splits, q).numpy()
        assert (sid[[0, 1, 5]] == 3).all(), sid
        assert (sid[[2, 3]] == 0).all(), sid
        found, hops = TF.search_batch(fcfg, f, q)
        hops_by_engine[engine, fused] = hops.numpy()
        np.testing.assert_array_equal(
            found.numpy(), [False, False, False, False, False, False, True])
        sf, sv = TF.successor_jit(fcfg, f, q)
        np.testing.assert_array_equal(
            sf.numpy(), [False, False, True, True, False, False, True])
        assert int(sv[2]) == 10 and int(sv[3]) == 10 and int(sv[6]) == 250
        uk = torch.as_tensor(np.array([2**31 + 7, -3, 2**40, 30], np.int64))
        f, res, _ = TF.update_batch(fcfg, f, torch.full((4,), 1), uk)
        np.testing.assert_array_equal(res.numpy(),
                                      [False, False, False, True])
        assert TF.live_keys(fcfg, f).tolist() == [10, 30, 150, 250, 380]
        assert f.updates.tolist() == [1, 0, 0, 0]
    h = list(hops_by_engine.values())
    for other in h[1:]:
        np.testing.assert_array_equal(h[0], other)
    assert (h[0][[0, 1, 5]] == 0).all()


def test_successor_cross_shard_fallback_corners():
    """Cross-shard successor corners against the JAX single tree, through
    every dispatch: owner shard empty, a key above every live key (not
    found), and a fallback landing several shards to the right."""
    vals = np.asarray([10, 20, 350, 360], np.int32)   # shards 1, 2 empty
    jcfg = TreeConfig(height=4, max_dnodes=64, buf_cap=8)
    jt, _, _ = JDT.update_batch(jcfg, JDT.empty(jcfg),
                                jnp.full(4, 1, jnp.int32), jnp.asarray(vals))
    q = np.asarray([150, 250, 25, 370, 360, 5, 20], np.int32)
    cf, cv = (np.asarray(x) for x in JDT.successor_jit(jcfg, jt,
                                                       jnp.asarray(q)))
    np.testing.assert_array_equal(
        cf, [True, True, True, False, False, True, True])
    for engine, fused in (("scalar", False), ("scalar", True),
                          ("lockstep", False), ("lockstep", True)):
        fcfg = TF.ForestConfig(num_shards=4, key_max=400, fused=fused,
                               tree=TDT.TreeConfig(height=4, max_dnodes=64,
                                                   buf_cap=8, engine=engine))
        f = TF.bulk_build(fcfg, vals, splits=np.asarray([100, 200, 300]),
                          device="cpu")
        assert TF.live_keys(fcfg, f).tolist() == vals.tolist()
        sf, sv = TF.successor_jit(fcfg, f, q)
        np.testing.assert_array_equal(sf.numpy(), cf)
        np.testing.assert_array_equal(sv.numpy()[cf], cv[cf])
        assert sv.dtype == torch.int32


def test_equidepth_splits_balance():
    """The port's splits equal the JAX partitioner's, balanced samples,
    skewed ones and degenerate fallbacks alike."""
    rng = np.random.default_rng(1)
    sample = np.concatenate([
        rng.integers(1, 100, size=900),
        rng.integers(1_000_000, 2_000_000, size=100),
    ])
    bnd = TSP.equidepth_splits(sample, 4)
    np.testing.assert_array_equal(bnd, JSP.equidepth_splits(sample, 4))
    assert bnd.shape == (3,) and (np.diff(bnd) > 0).all()
    counts = np.bincount(TSP.shard_of_np(bnd, sample), minlength=4)
    assert counts.min() >= 0.15 * sample.size, counts
    for args in ((np.full(50, 7), 4, 1, 1000), (np.zeros(0), 5, 1, 99),
                 (np.arange(3), 8, 1, 20), (sample, 1, 1, 2**31 - 2),
                 (rng.integers(1, 10**6, 5000), 8, 1, 10**6)):
        np.testing.assert_array_equal(TSP.equidepth_splits(*args),
                                      JSP.equidepth_splits(*args))
    for s in (1, 3, 8):
        np.testing.assert_array_equal(TSP.equiwidth_splits(s),
                                      JSP.equiwidth_splits(s))
    bnd2 = TSP.equidepth_splits(np.full(50, 7), 4, key_min=1, key_max=1000)
    assert bnd2.shape == (3,) and (np.diff(bnd2) > 0).all()


# --------------------------------------------- 1-shard == the single tree --


def test_one_shard_forest_matches_core():
    """A one-shard forest equals the port's single tree (reads, results,
    live keys) and the JAX one-shard forest (arena, every step)."""
    jcfg = TreeConfig(height=4, max_dnodes=512, buf_cap=8)
    jfcfg = JF.ForestConfig(num_shards=1, tree=jcfg, key_max=200)
    fcfg = port_fcfg(jfcfg)
    cfg = port_cfg(jcfg)
    jf = JF.empty(jfcfg)
    f = TF.empty(fcfg, device="cpu")
    t = TDT.empty(cfg, device="cpu")
    rng = np.random.default_rng(2)
    for step in range(6):
        kinds, keys = _mixed_batch(rng, 20, 150)
        assert_cols_equal(TDT.search_batch(cfg, t, keys),
                          TF.search_batch(fcfg, f, keys), ("found", "hops"))
        jf, jres, jst = JF.update_batch(jfcfg, jf, jnp.asarray(kinds),
                                        jnp.asarray(keys))
        f, fres, fst = TF.update_batch(fcfg, f, kinds, keys)
        t, tres, _ = TDT.update_batch(cfg, t, kinds, keys)
        np.testing.assert_array_equal(fres.numpy(), tres.numpy())
        np.testing.assert_array_equal(fres.numpy(), np.asarray(jres))
        assert jst.asdict() == fst._asdict(), step
        assert_forests_equal(jf, f, f"step {step}")
        assert f.epoch == step + 1
        np.testing.assert_array_equal(TF.live_keys(fcfg, f),
                                      TDT.live_keys(cfg, t))
        _invariants(fcfg, f)
    q = rng.integers(0, 160, size=40).astype(np.int32)
    assert_cols_equal(TDT.successor_batch(cfg, t, q),
                      TF.successor_jit(fcfg, f, q), ("found", "succ"))


# ------------------------------------------- S>1 == single tree + JAX ------


@pytest.mark.parametrize("engine", ["scalar", "lockstep"])
def test_multishard_forest_matches_single_tree(engine):
    """Four shards against the JAX forest (every shard's arena after every
    batch, results, stats, reads), the port's single tree (live keys) and
    the oracle (searches, results, the cross-shard successor), with the
    structural invariants on every shard after every step."""
    jcfg = TreeConfig(height=4, max_dnodes=256, buf_cap=8, engine="scalar")
    jfcfg = JF.ForestConfig(num_shards=4, tree=jcfg, key_max=400)
    fcfg = TF.ForestConfig(num_shards=4, key_max=400,
                           tree=TDT.TreeConfig(height=4, max_dnodes=256,
                                               buf_cap=8, engine=engine))
    big = TDT.TreeConfig(height=4, max_dnodes=1024, buf_cap=8)
    jf = JF.empty(jfcfg)
    f = TF.empty(fcfg, device="cpu")
    t = TDT.empty(big, device="cpu")
    oracle = SetOracle()
    rng = np.random.default_rng(3)
    for step in range(6):
        kinds, keys = _mixed_batch(rng, 24, 300)
        found, hops = TF.search_batch(fcfg, f, keys)
        assert (found.numpy() == oracle.snapshot_search(keys)).all()
        assert_cols_equal(JF.search_batch(jfcfg, jf, jnp.asarray(keys)),
                          (found, hops), ("found", "hops"), step)
        jf, jres, jst = JF.update_batch(jfcfg, jf, jnp.asarray(kinds),
                                        jnp.asarray(keys))
        f, fres, fst = TF.update_batch(fcfg, f, kinds, keys)
        t, _, _ = TDT.update_batch(big, t, kinds, keys)
        np.testing.assert_array_equal(fres.numpy(),
                                      oracle.apply_updates(kinds, keys))
        np.testing.assert_array_equal(fres.numpy(), np.asarray(jres))
        assert jst.asdict() == fst._asdict(), step
        assert_forests_equal(jf, f, f"step {step}")
        np.testing.assert_array_equal(TF.live_keys(fcfg, f),
                                      TDT.live_keys(big, t))
        _invariants(fcfg, f)
    assert not TF.alloc_failed(f)
    assert TF.shard_load(f) == JF.shard_load(jf)
    live = oracle.keys()
    q = rng.integers(0, 420, size=64).astype(np.int32)
    sf, sv = TF.successor_jit(fcfg, f, q)
    idx = np.searchsorted(live, q, side="right")
    ef = idx < live.size
    es = np.where(ef, live[np.minimum(idx, live.size - 1)], 0)
    np.testing.assert_array_equal(sf.numpy(), ef)
    np.testing.assert_array_equal(sv.numpy()[ef], es[ef])
    f2 = TF.record_reads(fcfg, f, q)
    jf2 = JF.record_reads(jfcfg, jf, jnp.asarray(q))
    assert TF.shard_load(f2) == JF.shard_load(jf2) and f2.epoch == f.epoch


def test_bulk_build_equidepth_and_rebalance():
    """Equi-depth bulk build and rebalance equal the JAX forest's arenas
    and splits; balance restored, key set kept."""
    jcfg = TreeConfig(height=5, max_dnodes=512, buf_cap=8)
    jfcfg = JF.ForestConfig(num_shards=4, tree=jcfg)
    fcfg = port_fcfg(jfcfg)
    rng = np.random.default_rng(4)
    vals = np.unique(rng.integers(1, 10_000, size=2000).astype(np.int32))
    f = TF.bulk_build(fcfg, vals, device="cpu")
    assert_forests_equal(JF.bulk_build(jfcfg, vals), f, "equi-depth")
    np.testing.assert_array_equal(TF.live_keys(fcfg, f), vals.astype(np.int64))
    counts = TSP.shard_counts(fcfg, f)
    assert counts.sum() == vals.size
    assert counts.max() <= 1.5 * counts.mean()
    found, _ = TF.search_batch(fcfg, f, vals[:128])
    assert bool(found.all())
    bad = np.asarray([9990, 9994, 9997])
    skewed = TF.bulk_build(fcfg, vals, splits=bad, device="cpu")
    jskewed = JF.bulk_build(jfcfg, vals, splits=bad)
    assert_forests_equal(jskewed, skewed, "skewed")
    assert TSP.needs_rebalance(fcfg, skewed)
    assert JSP.needs_rebalance(jfcfg, jskewed)
    fixed = TSP.rebalance(fcfg, skewed)
    assert_forests_equal(JSP.rebalance(jfcfg, jskewed), fixed, "rebalanced")
    assert not TSP.needs_rebalance(fcfg, fixed)
    np.testing.assert_array_equal(TF.live_keys(fcfg, fixed),
                                  vals.astype(np.int64))
    _invariants(fcfg, fixed)


# ---------------------------------------------- update, then read again ---


def test_reads_after_expand_and_merge_see_new_links():
    """Reads of one forest before and after an update batch that Expands
    and one that Merges: the fused view (cached between reads) is rebuilt
    when the arena's links change, so fused reads equal the dense dispatch
    and the oracle after each; a read through the *older* handle (same
    arena, older epoch) gets a fresh view too.  Arenas equal JAX's."""
    jcfg = TreeConfig(height=4, max_dnodes=256, buf_cap=8, engine="scalar")
    jfcfg = JF.ForestConfig(num_shards=4, tree=jcfg, key_max=1000)
    mk = lambda fused: TF.ForestConfig(  # noqa: E731
        num_shards=4, key_max=1000, fused=fused,
        tree=TDT.TreeConfig(height=4, max_dnodes=256, buf_cap=8,
                            engine="lockstep"))
    fc_f, fc_d = mk(True), mk(False)
    vals = np.arange(10, 1000, 10, dtype=np.int32)
    jf = JF.bulk_build(jfcfg, vals)
    f = TF.bulk_build(fc_f, vals, device="cpu")
    oracle = SetOracle(vals)
    q = np.arange(0, 1010, 3, dtype=np.int32)

    def reads_agree(f, where):
        for fn in (TF.search_batch, TF.successor_jit):
            assert_cols_equal(fn(fc_d, f, q), fn(fc_f, f, q),
                              ("a", "b"), where)
        found, _ = TF.search_batch(fc_f, f, q)
        np.testing.assert_array_equal(found.numpy(),
                                      oracle.snapshot_search(q), where)

    TF.reset_fused_view_cache()
    reads_agree(f, "bulk")
    assert TF.fused_view_cache_stats()["builds"] == 1
    ins = np.arange(301, 331, dtype=np.int32)          # one leaf overflows
    dels = vals[(vals > 500) & (vals < 800)]           # ΔNodes drain
    for what, kinds, keys, stat in (
            ("expand", np.ones(ins.size, np.int32), ins, "expands"),
            ("merge", np.full(dels.size, 2, np.int32), dels, "merges")):
        old = f
        jf, _, jst = JF.update_batch(jfcfg, jf, jnp.asarray(kinds),
                                     jnp.asarray(keys))
        f, res, st = TF.update_batch(fc_f, f, kinds, keys)
        assert getattr(st, stat) > 0, (what, st)
        assert jst.asdict() == st._asdict(), what
        np.testing.assert_array_equal(res.numpy(),
                                      oracle.apply_updates(kinds, keys))
        assert_forests_equal(jf, f, what)
        _invariants(fc_f, f)
        builds = TF.fused_view_cache_stats()["builds"]
        reads_agree(old, f"{what}, older handle")   # same arena, old epoch
        reads_agree(f, what)
        assert TF.fused_view_cache_stats()["builds"] == builds + 2, what


# ------------------------------------------------------- map mode (x64) ---

_MAP_JAX = r'''
import sys
sys.path.insert(0, TESTS)
import numpy as np, jax.numpy as jnp
from repro.core import TreeConfig
from repro.distributed import forest as F
from _torch_parity import forest_record
rec = {}
fcfg = F.ForestConfig(num_shards=4, key_max=500,
                      tree=TreeConfig(height=4, max_dnodes=256, buf_cap=8,
                                      payload_bits=8))
f = F.empty(fcfg)
rng = np.random.default_rng(6)
for step in range(5):
    kinds = rng.integers(1, 3, size=16).astype(np.int32)
    keys = rng.integers(1, 400, size=16).astype(np.int32)
    pays = rng.integers(0, 255, size=16).astype(np.int32)
    for name, col in zip(("found", "payload", "hops"),
                         F.lookup_batch(fcfg, f, jnp.asarray(keys))):
        rec[f"{step}/lookup/{name}"] = np.asarray(col)
    f, res, st = F.update_batch(fcfg, f, jnp.asarray(kinds),
                                jnp.asarray(keys), jnp.asarray(pays))
    rec[f"{step}/res"] = np.asarray(res)
    rec[f"{step}/stats"] = np.asarray(list(st.asdict().values()))
    forest_record(rec, f"{step}/forest", f)
'''


@pytest.fixture(scope="module")
def jax_map(tmp_path_factory):
    return jax_npz(tmp_path_factory, "torch_forest_map",
                   f"TESTS = {TESTS!r}\n" + _MAP_JAX)


def test_forest_map_mode_x64(jax_map):
    """Map mode (int64 packed values): lookups, results, stats and every
    shard's arena equal the JAX forest's after every batch, and the live
    items equal the map oracle's."""
    from repro_torch.core.oracle import MapOracle

    rec = jax_map
    fcfg = TF.ForestConfig(num_shards=4, key_max=500,
                           tree=TDT.TreeConfig(height=4, max_dnodes=256,
                                               buf_cap=8, payload_bits=8))
    f = TF.empty(fcfg, device="cpu")
    oracle = MapOracle()
    rng = np.random.default_rng(6)
    for step in range(5):
        kinds = rng.integers(1, 3, size=16).astype(np.int32)
        keys = rng.integers(1, 400, size=16).astype(np.int32)
        pays = rng.integers(0, 255, size=16).astype(np.int32)
        got = TF.lookup_batch(fcfg, f, keys)
        want = [rec[f"{step}/lookup/{n}"] for n in ("found", "payload",
                                                    "hops")]
        assert_cols_equal(want, got, ("found", "payload", "hops"), step)
        ef, ep = oracle.snapshot_lookup(keys)
        assert (got[0].numpy() == ef).all()
        assert (got[1].numpy()[ef] == ep[ef]).all()
        f, res, st = TF.update_batch(fcfg, f, kinds, keys, pays)
        oracle.apply_updates(kinds, keys, pays)
        np.testing.assert_array_equal(rec[f"{step}/res"], res.numpy())
        np.testing.assert_array_equal(rec[f"{step}/stats"],
                                      list(st._asdict().values()))
        assert_forests_equal(prefixed(rec, f"{step}/forest"), f, step)
        assert TF.live_items(fcfg, f) == oracle.items(), step
        _invariants(fcfg, f)


def test_deprecated_free_functions_warn():
    """``repro_torch.distributed`` exports the JAX package's names; the
    free functions are deprecated shims that warn and resolve to
    ``distributed.forest``."""
    import repro_torch.distributed as D

    assert sorted(D.__all__) == sorted(JD.__all__)
    assert D.ForestConfig is TF.ForestConfig and D.router is TR
    for name in ("bulk_build", "search_batch", "update_batch", "live_keys"):
        with pytest.warns(DeprecationWarning, match=name):
            fn = getattr(D, name)
        assert fn is getattr(TF, name)
    with pytest.raises(AttributeError):
        D.no_such_name  # noqa: B018
    assert np_of(TF.empty(TF.ForestConfig(num_shards=2), device="cpu")
                 .splits).tolist() == [1073741824]
