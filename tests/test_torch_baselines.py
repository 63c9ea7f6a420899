"""PyTorch port: the paper's comparison structures (`core.baselines`;
mirrors tests/test_baselines.py).  The same numpy inputs go through the
JAX structures and the port's: built states, searches, every update
batch's results and states, touch traces and block counts are equal
exactly, and searches equal the set oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from repro.api import OpBatch as JOpBatch
from repro.api import make_index as jmake_index
from repro.core import baselines as JB
from repro.core.oracle import SetOracle
from repro_torch.api import OpBatch, make_index
from repro_torch.core import baselines as TB

from _torch_parity import (
    few_jax_executables,  # noqa: F401  (autouse)
    np_of,
)

NAMES = ("SortedArray", "StaticVEB", "PointerBST", "HashTable")
UPDATABLE = ("SortedArray", "StaticVEB", "PointerBST")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2)
    vals = np.unique(rng.integers(1, 50_000, size=4000).astype(np.int32))
    q = rng.integers(1, 50_000, size=1000).astype(np.int32)
    return vals, q


def assert_states_equal(js, ts, where=""):
    """Every JAX field equal (dtype, shape, values); host ints equal."""
    for name in js._fields:
        a, b = getattr(js, name), getattr(ts, name)
        if isinstance(a, int):
            assert a == b, (where, name, a, b)
            continue
        a, b = np.asarray(a), np_of(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, name)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}: {name}")


def update_batches(rng, vals, steps: int = 4, k: int = 64):
    """Mixed insert/delete batches with a key repeated inside a batch,
    deletes of absent keys, present keys, and insert -> delete -> insert
    of one key in one batch."""
    out = []
    for _ in range(steps):
        kinds = rng.choice([1, 2], size=k).astype(np.int32)
        keys = rng.integers(1, 50_000, size=k).astype(np.int32)
        keys[:8] = keys[8:16]                        # repeats
        keys[20:26] = rng.choice(vals, 6)            # present keys
        kinds[30:33] = (1, 2, 1)
        keys[30:33] = keys[40]
        out.append((kinds, keys))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_build_and_search_equal_jax_and_oracle(name, data):
    vals, q = data
    js = getattr(JB, name).build(vals)
    ts = getattr(TB, name).build(vals, device="cpu")
    assert_states_equal(js, ts, name)
    want = np.asarray(getattr(JB, name).search(js, jnp.asarray(q)))
    got = np_of(getattr(TB, name).search(ts, q))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.isin(q, vals))


@pytest.mark.parametrize("name", UPDATABLE)
def test_updates_equal_jax(name, data):
    """Four batches: per-op results, the whole state and a search after
    each equal the JAX structure's, and the results equal the oracle."""
    vals, q = data
    jcls, tcls = getattr(JB, name), getattr(TB, name)
    js, ts = jcls.build(vals), tcls.build(vals, device="cpu")
    oracle = SetOracle(vals)
    for i, (kinds, keys) in enumerate(update_batches(
            np.random.default_rng(5), vals)):
        js, jres = jcls.update(js, jnp.asarray(kinds), jnp.asarray(keys))
        ts, tres = tcls.update(ts, kinds, keys)
        np.testing.assert_array_equal(np_of(tres), np.asarray(jres))
        np.testing.assert_array_equal(np_of(tres),
                                      oracle.apply_updates(kinds, keys))
        assert_states_equal(js, ts, f"{name} batch {i}")
        np.testing.assert_array_equal(
            np_of(tcls.search(ts, q)), oracle.snapshot_search(q))


def test_sorted_array_full_cap_equals_jax(data):
    """At a full array the JAX loop drops the largest element on insert
    (or overwrites it with a larger key) while ``n`` keeps counting: the
    port replays that op by op, results and state equal."""
    vals, q = data
    cap = vals.size + 6
    js = JB.SortedArray.build(vals, cap=cap)
    ts = TB.SortedArray.build(vals, cap=cap, device="cpu")
    rng = np.random.default_rng(9)
    for i in range(3):
        kinds = np.ones(24, np.int32)
        kinds[::5] = 2
        keys = rng.integers(1, 60_000, size=24).astype(np.int32)
        keys[-1] = 59_999 - i                        # above every key
        js, jres = JB.SortedArray.update(js, jnp.asarray(kinds),
                                         jnp.asarray(keys))
        ts, tres = TB.SortedArray.update(ts, kinds, keys)
        np.testing.assert_array_equal(np_of(tres), np.asarray(jres))
        assert_states_equal(js, ts, f"full cap batch {i}")
    assert int(ts.n) > cap
    np.testing.assert_array_equal(
        np_of(TB.SortedArray.search(ts, q)),
        np.asarray(JB.SortedArray.search(js, jnp.asarray(q))))


def test_pointer_bst_revive_and_empty_tree():
    """From an empty tree: the first insert becomes the root; a marked
    node is revived by a later insert (JAX's revive), a deleted key is
    deleted once, and every batch's state equals JAX's."""
    js = JB.PointerBST.build(np.zeros(0, np.int32), cap=64)
    ts = TB.PointerBST.build(np.zeros(0, np.int32), cap=64, device="cpu")
    assert_states_equal(js, ts, "empty")
    batches = [([1, 1, 1, 2, 2], [40, 20, 60, 20, 20]),
               ([1, 1, 2, 1, 1], [20, 10, 40, 40, 50]),
               ([2, 1, 2, 1, 2], [99, 30, 60, 60, 10])]
    for i, (kinds, keys) in enumerate(batches):
        kinds = np.asarray(kinds, np.int32)
        keys = np.asarray(keys, np.int32)
        js, jres = JB.PointerBST.update(js, jnp.asarray(kinds),
                                        jnp.asarray(keys))
        ts, tres = TB.PointerBST.update(ts, kinds, keys)
        np.testing.assert_array_equal(np_of(tres), np.asarray(jres))
        assert_states_equal(js, ts, f"batch {i}")
    assert ts.depth == 3


PAST_CAP = [
    # n = 4 -> 8: 9 fills the last node (id 4); 0 gets id 5, linked left of
    # node 1 but never stored; a second insert of 0 reads node 4 through
    # the clamped id and "attaches" again; the delete of 0 misses; 3 is
    # deleted and revived
    ([1, 1, 1, 2, 2, 1], [9, 0, 0, 0, 3, 3]),
    # 12 links id 7 right of node 4, the last node: from here on a key
    # above 9 descends into a cycle, and none is used below
    ([1, 2, 1, 2], [12, 9, 9, 2]),
    # no insert, n past cap: deletes only
    ([2, 2, 2], [4, 0, 5]),
]


def _past_cap_trees():
    js = JB.PointerBST.build(np.arange(1, 5, dtype=np.int32), cap=5)
    ts = TB.PointerBST.build(np.arange(1, 5, dtype=np.int32), cap=5,
                             device="cpu")
    return js, ts


def test_pointer_bst_past_cap_equals_jax():
    """Past ``cap`` nodes the JAX loop drops a new node's writes but links
    its id and counts it in ``n``, and a descent through that id reads the
    last node (a clamped gather; a dropped scatter for its link or mark):
    the port gives the same results, arrays and later searches."""
    js, ts = _past_cap_trees()
    q = np.asarray([0, 1, 2, 3, 4, 5, 6, 9], np.int32)
    for i, (kinds, keys) in enumerate(PAST_CAP):
        kinds = np.asarray(kinds, np.int32)
        keys = np.asarray(keys, np.int32)
        js, jres = JB.PointerBST.update(js, jnp.asarray(kinds),
                                        jnp.asarray(keys))
        ts, tres = TB.PointerBST.update(ts, kinds, keys)
        np.testing.assert_array_equal(np_of(tres), np.asarray(jres))
        assert_states_equal(js, ts, f"past cap batch {i}")
        np.testing.assert_array_equal(
            np_of(TB.PointerBST.search(ts, q)),
            np.asarray(JB.PointerBST.search(js, jnp.asarray(q))))
    assert int(ts.n) == 8 and np_of(ts.left)[1] == 5 \
        and np_of(ts.right)[4] == 7
    assert np_of(tres).tolist() == [True, False, False]


def test_pointer_bst_past_cap_cycle_raises():
    """Where a descent through an id past ``cap`` comes back to that id,
    JAX's while loop never ends (so no JAX leg runs here); the port's
    update raises instead, and its search stops after ``depth`` steps
    with the key not found."""
    _, ts = _past_cap_trees()
    for kinds, keys in PAST_CAP[:2]:
        ts, _ = TB.PointerBST.update(ts, np.asarray(kinds, np.int32),
                                     np.asarray(keys, np.int32))
    assert not bool(TB.PointerBST.search(ts, [13])[0])
    with pytest.raises(ValueError, match="cycle"):
        TB.PointerBST.update(ts, np.ones(1, np.int32),
                             np.asarray([13], np.int32))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("block", [16, 64])
def test_touch_traces_and_block_counts_equal_jax(name, block, data):
    vals, q = data
    jtouch = getattr(JB, name).touch_fn(getattr(JB, name).build(vals))
    ttouch = getattr(TB, name).touch_fn(
        getattr(TB, name).build(vals, device="cpu"))
    assert all(jtouch(int(k)) == ttouch(int(k)) for k in q[:100])
    assert (TB.count_block_transfers(ttouch, q[:200], block)
            == JB.count_block_transfers(jtouch, q[:200], block))


def test_transfer_ordering(data):
    """The paper's Table 1 story: pointer chasing touches the most
    blocks, the vEB layout the fewest."""
    vals, q = data
    res = {}
    for cls in (TB.SortedArray, TB.StaticVEB, TB.PointerBST):
        st = cls.build(vals, device="cpu")
        res[cls.name] = TB.count_block_transfers(cls.touch_fn(st), q[:200],
                                                 64)
    assert res["static_veb"] < res["sorted_array"] < res["pointer_bst"], res


@pytest.mark.parametrize("backend", ["sorted_array", "pointer_bst",
                                     "static_veb"])
def test_backend_reads_equal_jax(backend, data):
    """Through ``make_index``: search, successor, range scans and
    ``successor_k`` (where the backend has them), live items and size
    equal the JAX backend's after an update batch with search rows."""
    vals, q = data
    jix = jmake_index(backend, initial=vals)
    tix = make_index(backend, initial=vals, device="cpu")
    kinds = np.random.default_rng(4).choice([0, 1, 2], 96).astype(np.int32)
    keys = q[:96]
    jix, jres = jix.insert_delete(JOpBatch.mixed(kinds, keys))
    tix, tres = tix.insert_delete(OpBatch.mixed(kinds, keys))
    np.testing.assert_array_equal(np_of(tres), np.asarray(jres))
    for a, b in zip(jix.search(jnp.asarray(q)), tix.search(q)):
        np.testing.assert_array_equal(np_of(b), np.asarray(a))
    import dataclasses

    cap = tix.capability
    # every field of JAX's Capability; the port's ``ranks`` (the
    # torch.distributed ranks a state spans) is 1 for a baseline
    jcap = dataclasses.asdict(jix.capability)
    assert {k: v for k, v in dataclasses.asdict(cap).items()
            if k in jcap} == jcap
    assert set(dataclasses.asdict(cap)) - set(jcap) == {"ranks"}
    assert cap.ranks == 1
    if cap.successor:
        for a, b in zip(jix.successor(jnp.asarray(q)), tix.successor(q)):
            np.testing.assert_array_equal(np_of(b), np.asarray(a))
    if cap.range_scan:
        starts, his = q[:32], q[:32] + np.int32(900)
        for a, b in zip(jix.spec.backend.scan(jix.cfg, jix.state,
                                              jnp.asarray(starts),
                                              jnp.asarray(his), 8),
                        tix.spec.backend.scan(tix.cfg, tix.state, starts,
                                              his, 8)):
            a, b = np.asarray(a), np_of(b)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
        page = tix.range_scan(100, 5000, max_items=16)
        jpage = jix.range_scan(100, 5000, max_items=16)
        assert page.items() == jpage.items() and page.more == jpage.more
        for a, b in zip(jix.successor_k(jnp.asarray(q[:40]), 5),
                        tix.successor_k(q[:40], 5)):
            np.testing.assert_array_equal(np_of(b), np.asarray(a))
    assert tix.live_items() == jix.live_items()
    assert tix.size() == jix.size()
