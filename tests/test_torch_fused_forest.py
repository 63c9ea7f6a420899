"""PyTorch port: the fused cross-shard frontier equals the dense per-shard
dispatch and the JAX forest (mirrors ``tests/test_fused_forest.py``).

For S in {1, 4, 8}, set and map mode, eager and deferred maintenance, one
op trace (`_torch_parity.forest_trace`) goes through the JAX forest (its
fused lockstep reads; updates under the scalar engine) and through the
port (fused lockstep, dense lockstep and dense scalar reads; updates under
the lockstep engine).  Every read — lookup (found, payload, hops),
successor, range scan and ``successor_k`` rows — equals JAX's and the
oracle's at every step, and after every update batch the results, the
``MaintenanceStats`` and every shard's arena equal JAX's bit for bit.
Read batches are 61 keys and scan batches 13 bands (S x 13 tiled lanes):
no multiple of 4 or 64.  Map mode runs the JAX side with x64 in a
subprocess (`_torch_parity.jax_npz`), one per shard count.

``test_fused_shard_map_8_devices`` (8 fake devices) has no counterpart:
the port keeps every shard on one card.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core.oracle import MapOracle, SetOracle
from repro_torch.distributed import forest as TF

from _torch_parity import (
    FOREST_MAX_ITEMS, FOREST_SUCC_K, SCAN_COLS, assert_cols_equal,
    assert_forests_equal, check_invariants, forest_cfgs, forest_trace,
    jax_forest_leg, jax_npz, np_of, prefixed,
)

KEY_HI = 1000
STEPS = 4
TESTS = str(Path(__file__).resolve().parent)


def _oracle_scan(live, starts, his, max_out):
    """Keys of the live set in (start, hi] per lane: (keys padded with 0,
    n, more)."""
    lo = np.searchsorted(live, starts, side="right")
    cnt = np.maximum(np.searchsorted(live, his, side="right") - lo, 0)
    n = np.minimum(cnt, max_out)
    j = np.arange(max_out)[None, :]
    idx = np.minimum(lo[:, None] + j, max(live.size - 1, 0))
    keys = np.where(j < n[:, None], live[idx] if live.size else 0, 0)
    return keys, n, cnt > max_out


def _port_leg(rec, num_shards, policy, payload_bits, seed):
    """Replay the trace of `jax_forest_leg` on the port and hold every
    read and update against ``rec``.  Returns the most shards that held
    buffered items after one batch."""
    fc_u, fc_f = forest_cfgs(num_shards, policy, payload_bits, KEY_HI,
                             jax=False)
    fc_d = dataclasses.replace(fc_f, fused=False)
    fc_s = dataclasses.replace(
        fc_f, tree=dataclasses.replace(fc_f.tree, engine="scalar"))
    assert TF._fused(fc_f) is not None and TF._fused(fc_s) is None
    init, pays, trace = forest_trace(seed, STEPS, KEY_HI,
                                     payload_bits=payload_bits)
    f = TF.bulk_build(fc_u, init, pays, device="cpu")
    oracle = (MapOracle(zip(init.tolist(), pays.tolist())) if payload_bits
              else SetOracle(init))
    cfg = fc_f.tree
    most_buffered = 0
    for i, st in enumerate(trace):
        q, starts, his = st["q"], st["st"], st["hi"]
        live = (np.asarray([k for k, _ in oracle.items()], np.int64)
                if payload_bits else oracle.keys().astype(np.int64))
        reads = {
            "lookup": (("found", "payload", "hops"),
                       lambda fc: TF.lookup_batch(fc, f, q)),
            "succ": (("found", "succ"),
                     lambda fc: TF.successor_jit(fc, f, q)),
            "scan": (SCAN_COLS, lambda fc: TF.scan_batch(
                fc, f, starts, his, max_items=FOREST_MAX_ITEMS)),
            "succk": (SCAN_COLS,
                      lambda fc: TF.successor_k(fc, f, q, FOREST_SUCC_K)),
        }
        for read, (names, fn) in reads.items():
            want = [rec[f"{i}/{read}/{n}"] for n in names]
            if read in ("scan", "succk"):
                # the JAX forest sums n and hops over shards with jnp.sum,
                # which x64 (map mode) widens to int64; the contract, and
                # JAX without x64, is int32
                want = [np.asarray(w, np.int32) if n in ("n", "hops")
                        else w for n, w in zip(names, want)]
            for fc in (fc_f, fc_d, fc_s):
                assert_cols_equal(want, fn(fc), names,
                                  (i, read, fc.fused, fc.tree.engine))
        found, pay, _ = TF.lookup_batch(fc_f, f, q)
        if payload_bits:
            ef, ep = oracle.snapshot_lookup(q)
            np.testing.assert_array_equal(np_of(pay)[ef], ep[ef])
        else:
            ef = oracle.snapshot_search(q)
        np.testing.assert_array_equal(np_of(found), ef)
        sf, sv = TF.successor_jit(fc_f, f, q)
        idx = np.searchsorted(live, q, side="right")
        has = idx < live.size
        np.testing.assert_array_equal(np_of(sf), has)
        np.testing.assert_array_equal(np_of(sv)[has], live[idx[has]])
        out, n, _, more = TF.scan_batch(fc_f, f, starts, his,
                                        max_items=FOREST_MAX_ITEMS)
        keys, wn, wmore = _oracle_scan(live, starts, his, FOREST_MAX_ITEMS)
        span = np.arange(FOREST_MAX_ITEMS)[None, :] < np_of(n)[:, None]
        np.testing.assert_array_equal(
            np.where(span, np_of(cfg.key_of(out)), 0), keys)
        np.testing.assert_array_equal(np_of(n), wn)
        np.testing.assert_array_equal(np_of(more), wmore)
        f, res, stats = TF.update_batch(fc_u, f, st["kinds"], st["keys"],
                                        st["pays"])
        if payload_bits:
            want_res = oracle.apply_updates(st["kinds"], st["keys"],
                                            st["pays"])
        else:
            want_res = oracle.apply_updates(st["kinds"], st["keys"])
        np.testing.assert_array_equal(np_of(res), want_res)
        np.testing.assert_array_equal(rec[f"{i}/res"], np_of(res))
        np.testing.assert_array_equal(rec[f"{i}/stats"],
                                      list(stats._asdict().values()))
        assert_forests_equal(prefixed(rec, f"{i}/forest"), f, i)
        for s in range(num_shards):
            check_invariants(cfg, TF.shard_tree(f, s),
                             require_empty_buffers=policy == "eager")
        most_buffered = max(most_buffered,
                            int((f.trees.bcount.sum(1) > 0).sum()))
    assert not TF.alloc_failed(f)
    return most_buffered


def _check_buffered(policy, num_shards, most_buffered):
    if policy == "eager":
        assert most_buffered == 0
    else:   # the deferred leg leaves items buffered in several shards
        assert most_buffered >= min(num_shards, 2), most_buffered


@pytest.mark.parametrize("policy", ["eager", "deferred"])
@pytest.mark.parametrize("num_shards", [1, 4, 8])
def test_fused_matches_dense_dispatch(num_shards, policy):
    """Set mode: fused = dense (lockstep and scalar) = JAX fused = oracle
    for every read, arenas = JAX's after every batch."""
    seed = 31 + num_shards
    rec = jax_forest_leg(num_shards, policy, 0, seed=seed, steps=STEPS,
                         key_hi=KEY_HI)
    _check_buffered(policy, num_shards,
                    _port_leg(rec, num_shards, policy, 0, seed))


_MAP_JAX = r'''
import sys
sys.path.insert(0, TESTS)
from _torch_parity import jax_forest_leg
rec = {}
for policy in ("eager", "deferred"):
    leg = jax_forest_leg(S, policy, 8, seed=41 + S, steps=STEPS,
                         key_hi=KEY_HI)
    rec.update({f"{policy}/{k}": v for k, v in leg.items()})
'''


@pytest.mark.parametrize("policy", ["eager", "deferred"])
@pytest.mark.parametrize("num_shards", [1, 4, 8])
def test_fused_map_mode_x64(tmp_path_factory, num_shards, policy):
    """Map mode (int64 packed values, 8 payload bits): the same checks,
    payloads included, against the JAX forest run with x64."""
    head = (f"TESTS = {TESTS!r}\nS = {num_shards}\nSTEPS = {STEPS}\n"
            f"KEY_HI = {KEY_HI}\n")
    rec = jax_npz(tmp_path_factory, f"torch_fused_forest_map_{num_shards}",
                  head + _MAP_JAX)
    _check_buffered(policy, num_shards,
                    _port_leg(prefixed(rec, policy), num_shards, policy, 8,
                              41 + num_shards))


def test_fused_capability_and_dispatch_selection():
    """Capability.fused_forest reflects engine x fused flag; the scalar
    engine (no forest_batch) always reads through the dense dispatch; the
    Index reports the tree's engine and policy; a stats-collecting forest
    (which raised until obs/ was ported) returns ReadStats with its
    router leg."""
    from repro_torch.api import make_index

    initial = np.asarray([5, 9, 40], np.int32)
    kw = dict(initial=initial, num_shards=2, height=4, max_dnodes=64,
              buf_cap=8, key_max=64, device="cpu")
    ix = make_index("forest", engine="lockstep", maintenance="deferred",
                    **kw)
    assert ix.capability.fused_forest and ix.capability.sharded
    assert ix.engine == "lockstep" and ix.maintenance == "deferred"
    assert not make_index("forest", engine="lockstep", fused=False,
                          **kw).capability.fused_forest
    assert not make_index("forest", engine="scalar",
                          **kw).capability.fused_forest
    assert not make_index("deltatree", engine="lockstep", initial=initial,
                          height=4, max_dnodes=64,
                          device="cpu").capability.fused_forest
    stats = make_index("forest", collect_stats=True, **kw)
    assert stats.collect_stats
    found, _, rs = stats.search([5, 6, 40])
    assert found.tolist() == [True, False, True]
    assert rs.router.lanes.tolist() == [2, 1]


def test_fused_view_cache_counts_builds_and_hits():
    """Reads of an unchanged forest reuse one fused view (hits); an update
    or a flush bumps the epoch and the next read rebuilds it; the dense
    dispatch never touches the cache."""
    from repro_torch.api import OpBatch, make_index

    kw = dict(initial=np.arange(3, 900, 7), num_shards=4, height=4,
              max_dnodes=128, buf_cap=8, key_max=1000, device="cpu")
    ix = make_index("forest", engine="lockstep", **kw)
    dense = make_index("forest", engine="lockstep", fused=False, **kw)
    q = np.arange(1, 1000, 37, dtype=np.int32)
    TF.reset_fused_view_cache()
    for _ in range(3):
        ix.search(q)
        dense.search(q)
    ix.successor(q)
    ix.successor_k(q, 4)
    assert TF.fused_view_cache_stats() == {"builds": 1, "hits": 4, "size": 1}
    ix, _ = ix.insert_delete(OpBatch.inserts([500, 501, 502]))
    assert ix.state.epoch == 1
    ix.search(q)
    ix, _ = ix.flush()
    ix.search(q)
    ix.search(q)
    assert TF.fused_view_cache_stats() == {"builds": 3, "hits": 5, "size": 1}
