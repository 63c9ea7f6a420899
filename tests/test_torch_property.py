"""PyTorch port: randomized parity.

- Hypothesis legs (the port against its own oracles; the port's copies of
  tests/test_maintenance_property.py and tests/test_deltatree_property.py
  with their strategies and sizes, and one map-mode leg under
  ``deferred``).  Every leg draws its examples with ``derandomize=True``
  and no example database, so each run tests the same examples.
- Seeded JAX legs: fixed op sequences from a numpy seed
  (`_torch_traces.seeded_sequences`) run through ``repro.core.deltatree``
  and the port; reads, results, stats and the whole arena are equal
  after every batch.  Each (policy, engine) pair runs at one of the
  heights 3, 4, 5 and each height under two pairs (a JAX compile costs
  seconds per configuration, so not all 18).  Batches are padded with
  trailing searches to one width, so JAX compiles once per
  configuration; the port shows the padding changes nothing.
- The Expand that keeps an item (`deltatree._process_ins`, a buffered
  value whose descent lands in a child whose buffer is full): the
  committed traces `_torch_traces.KEEP_TRACES` under ``eager`` and
  ``budgeted:2``, equal to JAX after every batch, with the keep read
  from the state.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import deltatree as JDT
from repro_torch.core import deltatree as TDT
from repro_torch.core.oracle import MapOracle, SetOracle
from repro_torch.maintenance import scheduler as MS

import _torch_traces as T
from _torch_parity import (
    assert_cols_equal,
    assert_trees_equal,
    check_invariants,
    few_jax_executables,  # noqa: F401  (autouse)
    port_cfg,
)

POLICIES, ENGINES = T.POLICIES, T.ENGINES
HYP = dict(derandomize=True, database=None, deadline=None)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The arenas are a few KB: one thread a worker runs them fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def op_batches(max_batches: int):
    """JAX's strategy: up to ``max_batches`` batches of 1-12 (kind, key)
    pairs, kinds insert / delete, keys 1-40."""
    return st.lists(
        st.lists(st.tuples(st.integers(1, 2), st.integers(1, 40)),
                 min_size=1, max_size=12),
        min_size=1, max_size=max_batches)


def _arrays(batch):
    kinds = np.asarray([k for k, _ in batch], np.int32)
    keys = np.asarray([v for _, v in batch], np.int32)
    return kinds, keys


def _check_reads(cfg, t, oracle, keys):
    """search and successor of ``keys`` equal the oracle's snapshot."""
    found, _ = TDT.search_jit(cfg, t, keys)
    np.testing.assert_array_equal(found.numpy(), oracle.snapshot_search(keys))
    fs, sc = TDT.successor_jit(cfg, t, keys)
    live = oracle.keys()
    idx = np.searchsorted(live, keys, side="right")
    ef = idx < live.size
    np.testing.assert_array_equal(fs.numpy(), ef)
    np.testing.assert_array_equal(sc.numpy()[ef], live[idx[ef]])


# --------------------------------------------------------------------------
# hypothesis legs: the port against its oracles
# --------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("policy", POLICIES)
@settings(max_examples=20, **HYP)
@given(batches=op_batches(5))
def test_property_policies_match_oracle(batches, policy, engine):
    """Every policy x engine: interleaved search, successor and update
    agree with the oracle (searches include keys pending in buffers under
    deferred / budgeted), and flush restores I5."""
    cfg = TDT.TreeConfig(height=3, max_dnodes=256, buf_cap=4,
                         maintenance=policy, engine=engine)
    t = TDT.empty(cfg, device="cpu")
    oracle = SetOracle()
    for batch in batches:
        kinds, keys = _arrays(batch)
        _check_reads(cfg, t, oracle, keys)
        t, res, _ = TDT.update_batch(cfg, t, kinds, keys)
        np.testing.assert_array_equal(res.numpy(),
                                      oracle.apply_updates(kinds, keys))
        assert not bool(t.alloc_fail)
        np.testing.assert_array_equal(TDT.live_keys(cfg, t), oracle.keys())
    check_invariants(cfg, t, require_empty_buffers=(policy == "eager"))
    t, fstats = TDT.flush(cfg, t)
    assert fstats.pending == 0
    np.testing.assert_array_equal(TDT.live_keys(cfg, t), oracle.keys())
    check_invariants(cfg, t)


@pytest.mark.parametrize("height", [3, 4, 5])
@settings(max_examples=20, **HYP)
@given(batches=op_batches(6))
def test_op_sequences_match_oracle(batches, height):
    cfg = TDT.TreeConfig(height=height, max_dnodes=512, buf_cap=8)
    t = TDT.empty(cfg, device="cpu")
    oracle = SetOracle()
    for batch in batches:
        kinds, keys = _arrays(batch)
        found, _ = TDT.search_jit(cfg, t, keys)
        np.testing.assert_array_equal(found.numpy(),
                                      oracle.snapshot_search(keys))
        t, res, _ = TDT.update_batch(cfg, t, kinds, keys)
        np.testing.assert_array_equal(res.numpy(),
                                      oracle.apply_updates(kinds, keys))
        assert not bool(t.alloc_fail)
    np.testing.assert_array_equal(TDT.live_keys(cfg, t), oracle.keys())
    check_invariants(cfg, t)


@pytest.mark.parametrize("height", [3, 5, 7])
@settings(max_examples=10, **HYP)
@given(keys=st.lists(st.integers(1, 10_000), min_size=1, max_size=60,
                     unique=True))
def test_insert_all_then_find_all(keys, height):
    cfg = TDT.TreeConfig(height=height, max_dnodes=1024, buf_cap=8)
    t = TDT.empty(cfg, device="cpu")
    arr = np.asarray(keys, np.int32)
    for chunk in np.array_split(arr, max(1, len(arr) // 8)):
        t, res, _ = TDT.update_batch(cfg, t, np.ones(chunk.size, np.int32),
                                     chunk)
        assert bool(res.all())
    found, _ = TDT.search_jit(cfg, t, arr)
    assert bool(found.all())
    np.testing.assert_array_equal(TDT.live_keys(cfg, t), np.sort(arr))
    check_invariants(cfg, t)


@settings(max_examples=20, **HYP)
@given(batches=st.lists(
    st.lists(st.tuples(st.integers(1, 2), st.integers(1, 40),
                       st.integers(0, 255)), min_size=1, max_size=12),
    min_size=1, max_size=5))
def test_map_mode_deferred_matches_oracle(batches):
    """Map mode under ``deferred``: lookups (found and payload, buffered
    items included) and results agree with the map oracle; flush restores
    I5 and keeps every item."""
    cfg = TDT.TreeConfig(height=3, max_dnodes=256, buf_cap=4,
                         payload_bits=8, maintenance="deferred",
                         engine="lockstep")
    t = TDT.empty(cfg, device="cpu")
    oracle = MapOracle()
    for batch in batches:
        kinds = np.asarray([k for k, _, _ in batch], np.int32)
        keys = np.asarray([v for _, v, _ in batch], np.int32)
        pays = np.asarray([p for _, _, p in batch], np.int32)
        found, pay, _ = TDT.lookup_jit(cfg, t, keys)
        want_f, want_p = oracle.snapshot_lookup(keys)
        np.testing.assert_array_equal(found.numpy(), want_f)
        np.testing.assert_array_equal(pay.numpy()[want_f], want_p[want_f])
        t, res, _ = TDT.update_batch(cfg, t, kinds, keys, pays)
        np.testing.assert_array_equal(
            res.numpy(), oracle.apply_updates(kinds, keys, pays))
        assert TDT.live_items(cfg, t) == oracle.items()
    check_invariants(cfg, t, require_empty_buffers=False)
    t, fstats = TDT.flush(cfg, t)
    assert fstats.pending == 0
    assert TDT.live_items(cfg, t) == oracle.items()
    check_invariants(cfg, t)


# --------------------------------------------------------------------------
# seeded JAX legs, bit for bit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("policy,engine,height", T.SEQ_CONFIGS)
def test_seeded_sequences_equal_jax(policy, engine, height):
    jcfg = JDT.TreeConfig(height=height, maintenance=policy, engine=engine,
                          **T.SEQ_CFG)
    cfg = port_cfg(jcfg)
    seqs = T.seeded_sequences(T.seq_seed(policy, engine, height))
    for s, seq in enumerate(seqs):
        jt = JDT.empty(jcfg)
        tt = TDT.empty(cfg, device="cpu")
        bare = TDT.empty(cfg, device="cpu")     # the same batches unpadded
        for b, (kinds, keys) in enumerate(seq):
            where = f"{policy}/{engine}/h{height} seq {s} batch {b}"
            pk, pq = T.pad(kinds, keys)
            assert_cols_equal(JDT.search_jit(jcfg, jt, jnp.asarray(pq)),
                              TDT.search_jit(cfg, tt, pq), ("found", "hops"),
                              where)
            assert_cols_equal(JDT.successor_jit(jcfg, jt, jnp.asarray(pq)),
                              TDT.successor_jit(cfg, tt, pq),
                              ("found", "succ"), where)
            jt, jres, jst = JDT.update_batch(jcfg, jt, jnp.asarray(pk),
                                             jnp.asarray(pq))
            tt, tres, tst = TDT.update_batch(cfg, tt, pk, pq)
            np.testing.assert_array_equal(np.asarray(jres), tres.numpy())
            assert jst.asdict() == tst._asdict(), where
            assert_trees_equal(jt, tt, where)
            bare, bres, bst = TDT.update_batch(cfg, bare, kinds, keys)
            np.testing.assert_array_equal(bres.numpy(),
                                          tres.numpy()[:kinds.size])
            assert bst == tst, where
            assert_trees_equal(TDT.to_numpy(tt), bare, where + " unpadded")


# --------------------------------------------------------------------------
# the Expand that keeps an item
# --------------------------------------------------------------------------


@pytest.mark.parametrize("policy", sorted(T.KEEP_TRACES))
def test_expand_keep_equals_jax(policy, monkeypatch):
    """The committed trace (`_torch_traces.KEEP_TRACES`) makes an Expand
    keep an item: right after `_process_ins` ran an Expand on the parent,
    the parent's buffer still holds the item (under ``budgeted:2`` the
    round's residual mask marks it); JAX's arena, results and stats equal
    the port's after every batch."""
    jcfg = JDT.TreeConfig(maintenance=policy, **T.KEEP_CFG)
    cfg = port_cfg(jcfg)
    jt = JDT.bulk_build(jcfg, T.KEEP_INIT)
    tt = TDT.bulk_build(cfg, T.KEEP_INIT, device="cpu")
    keeps, residual = [], []
    process_ins, forced_mask = TDT._process_ins, MS._forced_mask

    def watch_ins(cfg, t, dn):
        t, rebuilds, expands = process_ins(cfg, t, dn)
        if rebuilds == 0 and int(t.bcount[dn]) > 0:
            keeps.append((step, int(dn), t.buf[dn].tolist()))
        return t, rebuilds, expands

    def watch_forced(cfg, t, pending, res, dns):
        residual.append((step, torch.nonzero(res)[:, 0].tolist()))
        return forced_mask(cfg, t, pending, res, dns)

    monkeypatch.setattr(TDT, "_process_ins", watch_ins)
    monkeypatch.setattr(MS, "_forced_mask", watch_forced)
    oracle = SetOracle(T.KEEP_INIT)
    for step, batch in enumerate(T.keep_steps(policy)):
        if batch == "flush":
            jt, jst = JDT.flush(jcfg, jt, 1)
            tt, tst = TDT.flush(cfg, tt, 1)
        else:
            kinds, keys = batch
            jt, jres, jst = JDT.update_batch(jcfg, jt, jnp.asarray(kinds),
                                             jnp.asarray(keys))
            tt, tres, tst = TDT.update_batch(cfg, tt, kinds, keys)
            np.testing.assert_array_equal(np.asarray(jres), tres.numpy())
            np.testing.assert_array_equal(tres.numpy(),
                                          oracle.apply_updates(kinds, keys))
        assert jst.asdict() == tst._asdict(), (policy, step)
        assert_trees_equal(jt, tt, f"{policy} step {step}")
    at, parent, item = T.KEEP_AT[policy]
    assert keeps == [(at, parent, [item])], keeps
    if policy == "budgeted:2":
        assert (at, [parent]) in residual, residual
    np.testing.assert_array_equal(TDT.live_keys(cfg, tt), oracle.keys())
