"""PyTorch port: the ΔTree equals the JAX package bit for bit — bulk build,
the state carry-over, scalar and lockstep reads (found, payload, hops,
succ), every arena array after each eager update batch, MaintenanceStats,
and flush.  Map-mode legs run the JAX side with x64 in a subprocess."""

import dataclasses
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import deltatree as JDT
from repro.core import engine as JE
from repro.core import layout as JL
from repro_torch.core import deltatree as TDT
from repro_torch.core import engine as TE

from _subproc import run_py
from _torch_parity import (
    assert_cols_equal, assert_trees_equal, jax_arrays, np_of, port_cfg,
    few_jax_executables,  # noqa: F401  (autouse)
    to_port,
)


def _keys(seed, n=300, hi=3000):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(1, hi, n)).astype(np.int32)


def _queries(rng, n=200, hi=3300):
    """Present and absent keys, keys above every live key, the reserved
    ROUTE_LEFT key (router pad lanes) and KEY_MIN - 1."""
    q = rng.integers(1, hi, n).astype(np.int32)
    q[:3] = JL.ROUTE_LEFT
    q[3] = 0
    q[4] = JL.KEY_MAX
    return q


@pytest.mark.parametrize("h,m", [(3, 512), (4, 256), (5, 256)])
def test_bulk_build_byte_equal(h, m):
    jcfg = JDT.TreeConfig(height=h, max_dnodes=m, buf_cap=8)
    vals = _keys(h)
    assert_trees_equal(JDT.bulk_build(jcfg, vals),
                       TDT.bulk_build(port_cfg(jcfg), vals, device="cpu"))
    assert_trees_equal(JDT.empty(jcfg), TDT.empty(port_cfg(jcfg), "cpu"))


def test_from_to_numpy_round_trip():
    jcfg = JDT.TreeConfig(height=4, max_dnodes=256, buf_cap=8)
    jt = JDT.bulk_build(jcfg, _keys(1))
    cfg, tt = to_port(jcfg, jt)
    back = TDT.to_numpy(tt)
    for name, a in jax_arrays(jt).items():
        assert back[name].dtype == a.dtype and back[name].shape == a.shape
        np.testing.assert_array_equal(back[name], a, err_msg=name)
    assert back["root"].shape == () and back["alloc_fail"].dtype == np.bool_
    # map mode: int64 packed value/buf survive the trip unchanged
    mcfg = TDT.TreeConfig(height=4, max_dnodes=256, buf_cap=8,
                          payload_bits=12)
    vals = _keys(2)
    mt = TDT.bulk_build(mcfg, vals, vals % 4000, device="cpu")
    arrays = TDT.to_numpy(mt)
    arrays["buf"][3, :2] = (np.int64(5) << 12) | 7, np.int64(1) << 62
    again = TDT.to_numpy(TDT.from_numpy(mcfg, arrays, "cpu"))
    for name in arrays:
        assert again[name].dtype == arrays[name].dtype
        np.testing.assert_array_equal(again[name], arrays[name])
    with pytest.raises(TypeError):
        TDT.from_numpy(cfg, arrays, "cpu")     # int64 rows into a set config


def _churn_pair(h, m, seed, engine, batches=6, **kw):
    """JAX and port trees driven through the same eager update batches;
    asserts equality of results, stats and all 16 arrays after each."""
    rng = np.random.default_rng(seed)
    jcfg = JDT.TreeConfig(height=h, max_dnodes=m, buf_cap=8, engine=engine,
                          **kw)
    cfg = port_cfg(jcfg)
    vals = _keys(seed)
    jt = JDT.bulk_build(jcfg, vals)
    tt = TDT.bulk_build(cfg, vals, device="cpu")
    for step in range(batches):
        n = 96
        # duplicates inside the batch, inserts of present keys, deletes of
        # absent ones; alternate insert- and delete-heavy batches so both
        # Expand and Merge run
        kinds = rng.choice([1, 1, 1, 2] if step % 2 == 0 else [2, 2, 2, 1],
                           n).astype(np.int32)
        kinds[rng.random(n) < 0.1] = 0
        keys = rng.integers(1, 3300, n).astype(np.int32)
        keys[n // 2: n // 2 + 8] = keys[:8]
        jt, jres, jstats = JDT.update_batch(jcfg, jt, jnp.asarray(kinds),
                                            jnp.asarray(keys))
        tt, tres, tstats = TDT.update_batch(cfg, tt, torch.as_tensor(kinds),
                                            torch.as_tensor(keys))
        np.testing.assert_array_equal(np.asarray(jres), tres.numpy(),
                                      err_msg=f"results step {step}")
        assert jstats.asdict() == tstats._asdict(), step
        assert_trees_equal(jt, tt, f"step {step}")
    return jcfg, jt, cfg, tt


@pytest.mark.parametrize("engine", ["scalar", "lockstep"])
@pytest.mark.parametrize("h,m", [(3, 512), (4, 256)])
def test_eager_updates_arena_equal(engine, h, m):
    jcfg, jt, cfg, tt = _churn_pair(h, m, seed=h + 7, engine=engine)
    np.testing.assert_array_equal(JDT.live_keys(jcfg, jt),
                                  TDT.live_keys(cfg, tt))
    assert JDT.live_items(jcfg, jt) == TDT.live_items(cfg, tt)


def test_eager_updates_sequential_path_equal():
    """parallel_updates=False sends every op down the sequential path."""
    _churn_pair(4, 256, seed=5, engine="lockstep", batches=3,
                parallel_updates=False)


def test_eager_updates_per_round_walk_equal():
    _churn_pair(4, 256, seed=6, engine="lockstep", batches=3,
                walk_fused=False)


@pytest.mark.parametrize("engine", ["scalar", "lockstep"])
@pytest.mark.parametrize("walk_fused", [True, False])
def test_reads_equal_jax(engine, walk_fused):
    """found, payload, hops and succ equal JAX on a churned tree, ROUTE_LEFT
    keys included, for both engines and both walk loops."""
    jcfg, jt, _, _ = _churn_pair(4, 256, seed=11, engine="scalar", batches=2)
    jcfg = dataclasses.replace(jcfg, engine=engine, walk_fused=walk_fused)
    cfg, tt = to_port(jcfg, jt)
    q = _queries(np.random.default_rng(3))
    assert_cols_equal(JE.lookup(jcfg, jt, jnp.asarray(q)),
                      TE.lookup(cfg, tt, torch.as_tensor(q)),
                      ("found", "payload", "hops"), engine)
    assert_cols_equal(JE.successor(jcfg, jt, jnp.asarray(q)),
                      TE.successor(cfg, tt, torch.as_tensor(q)),
                      ("found", "succ"), engine)
    found, hops = TE.search(cfg, tt, q)
    np.testing.assert_array_equal(found.numpy(),
                                  np.asarray(JE.search(jcfg, jt, q)[0]))


def test_scalar_helpers_equal_jax():
    jcfg, jt, _, _ = _churn_pair(4, 256, seed=12, engine="scalar", batches=2)
    cfg, tt = to_port(jcfg, jt)
    for key in _queries(np.random.default_rng(4), n=12)[3:]:
        key = int(key)
        jf, jp, jh = JDT.search_one(jcfg, jt, key)
        assert TDT.search_one(cfg, tt, key) == (bool(jf), int(jp), int(jh))
        sf, sk = JDT.successor_one(jcfg, jt, key)
        assert TDT.successor_one(cfg, tt, key) == (bool(sf), int(sk))
        q = int(np.asarray(jcfg.qpack(key)))
        jd = JDT._descend(jcfg, jt, jnp.int32(q), jt.root, 1)
        assert TDT._descend(cfg, tt, q, int(tt.root), 1) == tuple(
            int(x) for x in jd)


def _deferred_tree(seed):
    """A JAX tree with pending maintenance (full buffers, flags) — the
    state `flush` and the buffered-floor reads act on."""
    rng = np.random.default_rng(seed)
    jcfg = JDT.TreeConfig(height=4, max_dnodes=256, buf_cap=8,
                          maintenance="deferred")
    jt = JDT.bulk_build(jcfg, _keys(seed))
    for _ in range(3):
        kinds = rng.choice([1, 1, 2], 96).astype(np.int32)
        keys = rng.integers(1, 3300, 96).astype(np.int32)
        jt, _, _ = JDT.update_batch(jcfg, jt, jnp.asarray(kinds),
                                    jnp.asarray(keys))
    assert int(np.asarray(jt.bcount).sum()) > 0
    return jcfg, jt


def test_flush_equal_jax():
    jcfg, jt = _deferred_tree(21)
    cfg, tt = to_port(jcfg, jt)
    jt, jstats = JDT.flush(jcfg, jt)
    tt, tstats = TDT.flush(cfg, tt)
    assert jstats.asdict() == tstats._asdict()
    assert tstats.rounds > 0 and tstats.pending == 0
    assert_trees_equal(jt, tt, "flush")


def test_buffered_floor_and_member_equal_jax():
    jcfg, jt = _deferred_tree(22)
    cfg, tt = to_port(jcfg, jt)
    buffered = np.asarray(jt.buf)[np.asarray(jt.buf) != 0][:20]
    q = np.concatenate([buffered, buffered - 1,
                        _queries(np.random.default_rng(5), n=60)])
    q = q.astype(np.int32)
    for name in ("buffered_floor", "buffered_member"):
        want = getattr(JDT, name)(jcfg, jt, jnp.asarray(q))
        got = getattr(TDT, name)(cfg, tt, torch.as_tensor(q))
        assert_cols_equal([want], [got], [name])
    assert np_of(TDT.buffered_member(cfg, tt, torch.as_tensor(q)))[:20].all()


@pytest.mark.parametrize("engine", ["scalar", "lockstep"])
def test_map_mode_equal_jax(engine):
    """Map mode (int64 packed rows, payloads): bulk build, reads and every
    eager update batch equal JAX, run with x64 in a subprocess."""
    code = "ENGINE = %r\n" % engine + r'''
import json, numpy as np, jax.numpy as jnp, torch
import sys; sys.path.insert(0, "tests")
from _torch_parity import assert_cols_equal, assert_trees_equal, port_cfg, to_port
from repro.core import deltatree as JDT, engine as JE
from repro_torch.core import deltatree as TDT, engine as TE
rng = np.random.default_rng(9)
vals = np.unique(rng.integers(1, 3000, 300)).astype(np.int32)
pays = rng.integers(0, 4095, vals.size).astype(np.int32)
for engine in (ENGINE,):
    jcfg = JDT.TreeConfig(height=4, max_dnodes=256, buf_cap=8,
                          payload_bits=12, engine=engine)
    cfg = port_cfg(jcfg)
    jt = JDT.bulk_build(jcfg, vals, pays)
    tt = TDT.bulk_build(cfg, vals, pays, device="cpu")
    assert_trees_equal(jt, tt, "build")
    for step in range(4):
        q = rng.integers(1, 3300, 128).astype(np.int32)
        q[:2] = 2**31 - 1
        assert_cols_equal(JE.lookup(jcfg, jt, jnp.asarray(q)),
                          TE.lookup(cfg, tt, torch.as_tensor(q)),
                          ("found", "payload", "hops"), engine)
        assert_cols_equal(JE.successor(jcfg, jt, jnp.asarray(q)),
                          TE.successor(cfg, tt, torch.as_tensor(q)),
                          ("found", "succ"), engine)
        kinds = rng.choice([1, 1, 2], 96).astype(np.int32)
        keys = rng.integers(1, 3300, 96).astype(np.int32)
        p = rng.integers(-5, 5000, 96).astype(np.int32)
        jt, jr, js = JDT.update_batch(jcfg, jt, jnp.asarray(kinds),
                                      jnp.asarray(keys), jnp.asarray(p))
        tt, tr, ts = TDT.update_batch(cfg, tt, torch.as_tensor(kinds),
                                      torch.as_tensor(keys), torch.as_tensor(p))
        assert (np.asarray(jr) == tr.numpy()).all(), step
        assert js.asdict() == ts._asdict(), step
        assert_trees_equal(jt, tt, f"{engine} step {step}")
    assert JDT.live_items(jcfg, jt) == TDT.live_items(cfg, tt)
print(json.dumps({"ok": True}))
'''
    out = run_py(code, x64=True, timeout=600)
    assert json.loads(out.strip().splitlines()[-1])["ok"]


def _clustered_batches(rng, n_batches, nb=64, hi=2000):
    """Update batches whose keys crowd a narrow window, so tiny buffers
    fill: ops stay pending, later ops on their keys wait, and Expand keeps
    items it cannot move into a full child buffer."""
    for _ in range(n_batches):
        kinds = rng.choice([1, 1, 2], nb).astype(np.int32)
        centre = rng.integers(1, hi)
        keys = np.clip(centre + rng.integers(-40, 40, nb), 1, None)
        yield kinds, keys.astype(np.int32), rng.integers(0, 100, nb).astype(
            np.int32)


def _pair_from(jcfg, vals):
    return (JDT.bulk_build(jcfg, vals),
            TDT.bulk_build(port_cfg(jcfg), vals, device="cpu"))


def test_eager_updates_tiny_buffers_equal():
    rng = np.random.default_rng(1)
    jcfg = JDT.TreeConfig(height=3, max_dnodes=128, buf_cap=2,
                          engine="lockstep")
    cfg = port_cfg(jcfg)
    jt, tt = _pair_from(jcfg, _keys(1, n=30, hi=2000))
    for step, (kinds, keys, pays) in enumerate(_clustered_batches(rng, 4)):
        jt, jres, jstats = JDT.update_batch(
            jcfg, jt, jnp.asarray(kinds), jnp.asarray(keys), jnp.asarray(pays))
        tt, tres, tstats = TDT.update_batch(cfg, tt, kinds, keys, pays)
        np.testing.assert_array_equal(np.asarray(jres), tres.numpy())
        assert jstats.asdict() == tstats._asdict(), step
        assert tstats.rounds > 2      # repairs ran over several rounds
        assert_trees_equal(jt, tt, f"step {step}")
    assert not bool(tt.alloc_fail)


def _reachable_twice(child: np.ndarray, root: int):
    """A ΔNode reached by two child links from the root, or None."""
    seen, stack = set(), [root]
    while stack:
        dn = stack.pop()
        if dn in seen:
            return dn
        seen.add(dn)
        stack.extend(int(c) for c in child[dn] if c >= 0)
    return None


def test_arena_exhaustion_reuses_a_live_node():
    """A fault of the reference, reproduced bit for bit by the port: once
    the freelist is empty, every failing `_alloc` hands out
    ``free_stack[0]``, a ΔNode already linked into the tree, so Expand
    links it under more parents.  The sticky ``alloc_fail`` is set, but the
    arena is no longer a tree, and a later batch's descent can loop
    forever (in both packages).  See ROADMAP.md, Queue 3."""
    rng = np.random.default_rng(2)
    jcfg = JDT.TreeConfig(height=3, max_dnodes=40, buf_cap=2,
                          engine="lockstep")
    jt, tt = _pair_from(jcfg, _keys(2, n=30, hi=2000))
    kinds, keys, pays = next(_clustered_batches(rng, 1))
    jt, _, _ = JDT.update_batch(jcfg, jt, jnp.asarray(kinds),
                                jnp.asarray(keys), jnp.asarray(pays))
    tt, _, _ = TDT.update_batch(port_cfg(jcfg), tt, kinds, keys, pays)
    assert_trees_equal(jt, tt, "exhausted")
    assert bool(tt.alloc_fail) and int(tt.free_top) == 0
    shared = _reachable_twice(tt.child.numpy(), int(tt.root))
    assert shared == int(tt.free_stack[0])
