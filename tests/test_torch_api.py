"""PyTorch port: the Index API — a random op trace through the port's
``make_index("deltatree", engine="lockstep", device="cpu")`` equals the
JAX package's ``make_index`` and the oracle; every maintenance policy runs;
the comparison backends (``sorted_array``, ``pointer_bst``,
``static_veb``) follow the set-trace oracle conformance of
tests/test_api_conformance.py and its capability and engine gates; what
the port does not run yet raises; with no card and no explicit device the
entry points raise."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.api import OpBatch as JOpBatch
from repro.api import make_index as jmake_index
from repro.core.oracle import SetOracle
from repro_torch.api import CapabilityError, OpBatch, make_index
from repro_torch.core import deltatree as TDT

from _torch_parity import (
    assert_trees_equal,
    few_jax_executables,  # noqa: F401  (autouse)
)


@pytest.mark.parametrize("engine", ["lockstep", "scalar"])
def test_op_trace_equals_jax_and_oracle(engine):
    rng = np.random.default_rng(17)
    init = np.unique(rng.integers(1, 5000, 400)).astype(np.int32)
    kw = dict(height=4, max_dnodes=512, buf_cap=8, engine=engine)
    jix = jmake_index("deltatree", initial=init, **kw)
    tix = make_index("deltatree", initial=init, device="cpu", **kw)
    oracle = SetOracle(init)
    for step in range(5):
        kinds = rng.choice([0, 0, 1, 2], 128).astype(np.int32)
        keys = rng.integers(1, 5200, 128).astype(np.int32)
        tf, th = tix.search(keys)
        jf, jh = jix.search(jnp.asarray(keys))
        np.testing.assert_array_equal(tf.numpy(), oracle.snapshot_search(keys))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        tix, tres = tix.insert_delete(OpBatch.mixed(kinds, keys))
        jix, jres = jix.insert_delete(JOpBatch.mixed(kinds, keys))
        np.testing.assert_array_equal(tres.numpy(),
                                      oracle.apply_updates(kinds, keys))
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
        assert_trees_equal(jix.state, tix.state, f"step {step}")
    q = rng.integers(0, 5300, 64).astype(np.int32)
    tsf, tsk = tix.successor(q)
    jsf, jsk = jix.successor(jnp.asarray(q))
    np.testing.assert_array_equal(tsf.numpy(), np.asarray(jsf))
    np.testing.assert_array_equal(tsk.numpy(), np.asarray(jsk))
    live = oracle.keys()
    for k, f, s in zip(q, tsf.numpy(), tsk.numpy()):
        nxt = live[live > k]
        assert f == (nxt.size > 0) and (not f or s == nxt[0])
    assert tix.size() == jix.size() == len(oracle.s)
    assert tix.live_items() == jix.live_items()
    assert not tix.alloc_failed()
    tix, stats = tix.flush()
    assert stats.rounds == 0


def test_map_mode_lookup_and_capability():
    vals = np.arange(10, 400, 3, dtype=np.int32)
    ix = make_index("deltatree", initial=vals, payloads=vals * 2,
                    payload_bits=12, height=4, max_dnodes=128,
                    engine="lockstep", device="cpu")
    found, pay, _ = ix.lookup([10, 11, 13])
    assert found.tolist() == [True, False, True]
    assert pay.tolist() == [20, -1, 26]
    cap = ix.capability
    assert cap.map_mode and cap.successor
    assert cap.range_scan and cap.successor_k and cap.deferred_maintenance
    assert not (cap.sharded or cap.fused_forest)
    page = ix.range_scan(10, 20)
    assert page.items() == [(10, 20), (13, 26), (16, 32), (19, 38)]
    with pytest.raises(CapabilityError):
        make_index("deltatree", initial=vals, height=4, max_dnodes=128,
                   device="cpu").lookup([10])


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    """With no card, entry points without ``device="cpu"`` raise instead of
    running on the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TDT.TreeConfig(height=4, max_dnodes=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_index("deltatree", initial=[1, 2, 3], height=4, max_dnodes=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TDT.bulk_build(cfg, [1, 2, 3])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TDT.empty(cfg)
    assert make_index("deltatree", height=4, max_dnodes=64,
                      device="cpu").size() == 0


@pytest.mark.parametrize("policy", ["deferred", "budgeted:4"])
def test_relaxed_policies_run(policy):
    """An index under each relaxed policy takes updates, carries buffered
    items, reads them back and flushes to the oracle's live set."""
    rng = np.random.default_rng(5)
    init = np.unique(rng.integers(1, 400, 60)).astype(np.int32)
    ix = make_index("deltatree", initial=init, height=4, max_dnodes=256,
                    buf_cap=8, engine="lockstep", maintenance=policy,
                    device="cpu")
    assert ix.maintenance == policy and ix.capability.deferred_maintenance
    oracle = SetOracle(init)
    pending = 0
    for _ in range(4):
        kinds = rng.choice([0, 1, 1, 2], 32).astype(np.int32)
        keys = rng.integers(1, 400, 32).astype(np.int32)
        ix, res, stats = ix.update(OpBatch.mixed(kinds, keys))
        np.testing.assert_array_equal(res.numpy(),
                                      oracle.apply_updates(kinds, keys))
        pending = max(pending, stats.pending)
        assert ix.size() == len(oracle.s)
        np.testing.assert_array_equal(ix.search(keys)[0].numpy(),
                                      oracle.snapshot_search(keys))
    assert pending > 0
    assert ix.range_scan(1, 400, max_items=256).keys.tolist() == \
        sorted(oracle.s)
    ix, stats = ix.flush()
    assert stats.pending == 0
    assert [k for k, _ in ix.live_items()] == sorted(oracle.s)


@pytest.mark.parametrize("kw,exc", [
    (dict(maintenance="lazy"), ValueError),
    (dict(engine="nope"), ValueError),
])
def test_unported_options_raise(kw, exc):
    with pytest.raises(exc):
        make_index("deltatree", initial=[1, 2, 3], height=4, max_dnodes=64,
                   device="cpu", **kw)


def test_resolve_engine_auto_table():
    """`resolve_engine` as JAX's (tests/test_fused_walk.py): the table's
    ``cuda`` rows name lockstep; a miss (the CPU, a backend with no row)
    gives scalar; other names pass through."""
    from repro_torch.core.engine import resolve_engine

    assert resolve_engine("auto", "deltatree", "cuda") == "lockstep"
    assert resolve_engine("auto", "forest", "cuda") == "lockstep"
    assert resolve_engine("auto", "deltatree", "cpu") == "scalar"
    assert resolve_engine("auto", "sorted_array", "cuda") == "scalar"
    assert resolve_engine("lockstep", "deltatree", "cpu") == "lockstep"
    assert resolve_engine(None, "deltatree", "cuda") is None


@pytest.mark.parametrize("backend,kw", [
    ("deltatree", dict(height=3, max_dnodes=64)),
    ("forest", dict(num_shards=2, height=3, max_dnodes=64)),
    ("sorted_array", {}),
])
def test_make_index_auto_engine_cpu(backend, kw):
    """On the CPU ``engine="auto"`` misses the table and resolves to
    scalar; the index records the resolved name, never the sentinel."""
    ix = make_index(backend, initial=np.asarray([5, 9, 42], np.int32),
                    engine="auto", device="cpu", **kw)
    assert ix.engine == "scalar"
    found = ix.search(np.asarray([5, 7], np.int32))[0]
    np.testing.assert_array_equal(found.numpy(), [True, False])


def test_make_index_auto_winner_backend_cannot_run(monkeypatch):
    """A table winner the backend does not support resolves to scalar."""
    from repro_torch.core import engine as E

    monkeypatch.setitem(E.AUTO_TABLE, ("sorted_array", "cpu"), "lockstep")
    ix = make_index("sorted_array", initial=np.asarray([5, 9], np.int32),
                    engine="auto", device="cpu")
    assert ix.engine == "scalar"


def test_scheduler_rejects_non_eager_policy():
    """The scheduler takes every policy: `run_update` under ``deferred``
    equals the JAX scheduler (results, stats, all 16 arrays) on a batch
    that leaves items buffered, on both engines."""
    from repro.core import deltatree as JDT
    from repro.maintenance import scheduler as JMS
    from repro_torch.maintenance.scheduler import run_update

    from _torch_parity import port_cfg

    init = np.arange(2, 120, 3, dtype=np.int32)
    keys = np.arange(1, 120, 3, dtype=np.int32)[:32]
    kinds = np.ones(keys.size, np.int32)
    for engine in ("lockstep", "scalar"):
        jcfg = JDT.TreeConfig(height=4, max_dnodes=64, buf_cap=4,
                              engine=engine, maintenance="deferred")
        cfg = port_cfg(jcfg)
        jt, jres, jst = JMS.run_update(jcfg, JDT.bulk_build(jcfg, init),
                                       jnp.asarray(kinds), jnp.asarray(keys))
        tt, tres, tst = run_update(
            cfg, TDT.bulk_build(cfg, init, device="cpu"), kinds, keys)
        np.testing.assert_array_equal(np.asarray(jres), tres.numpy())
        assert jst.asdict() == tst._asdict() and tst.pending > 0
        assert_trees_equal(jt, tt, engine)


# ------------------------------------------------ comparison backends ---

BASELINES = ("sorted_array", "pointer_bst", "static_veb")
KEY_HI = 300
BUILD_KW = {"sorted_array": dict(cap=4096), "pointer_bst": dict(cap=4096),
            "static_veb": {}}


@pytest.mark.parametrize("backend", BASELINES)
def test_set_trace_matches_oracle(backend):
    """tests/test_api_conformance.py's set trace: wait-free searches see
    the pre-step snapshot, updates apply in batch order (OP_SEARCH rows
    are no-ops), size / live items / successors follow the oracle."""
    rng = np.random.default_rng(11)
    initial = np.unique(rng.integers(1, KEY_HI, 80).astype(np.int32))
    ix = make_index(backend, initial=initial, device="cpu",
                    **BUILD_KW[backend])
    oracle = SetOracle(initial)
    for _ in range(8):
        kinds = rng.integers(0, 3, size=24).astype(np.int32)
        keys = rng.integers(1, KEY_HI, size=24).astype(np.int32)
        f, hops = ix.search(keys)
        np.testing.assert_array_equal(f.numpy(), oracle.snapshot_search(keys))
        assert not hops.any()
        ix, res, stats = ix.update(OpBatch.mixed(kinds, keys))
        assert stats is None               # no maintenance scheduler
        np.testing.assert_array_equal(res.numpy(),
                                      oracle.apply_updates(kinds, keys))
        assert not ix.alloc_failed()
        assert ix.size() == len(oracle.s)
        assert [k for k, _ in ix.live_items()] == sorted(oracle.s)
        if ix.capability.successor:
            q = rng.integers(1, KEY_HI + 5, size=16).astype(np.int32)
            live = oracle.keys()
            fs, sc = ix.successor(q)
            idx = np.searchsorted(live, q, side="right")
            want = idx < live.size
            np.testing.assert_array_equal(fs.numpy(), want)
            np.testing.assert_array_equal(
                sc.numpy()[want], live[idx[want]])
    assert ix.flush() == (ix, None)


@pytest.mark.parametrize("backend", BASELINES)
def test_baseline_capability_and_engine_gates(backend):
    """Set-only backends refuse payloads and map-mode reads; successor
    where undeclared raises CapabilityError; engine="scalar" is accepted
    (validated, not threaded into the config), "lockstep" rejected; the
    maintenance knob takes "eager" only."""
    with pytest.raises(ValueError, match="payload"):
        make_index(backend, initial=[5], payloads=[1], device="cpu")
    ix = make_index(backend, initial=[5, 9], engine="scalar",
                    maintenance="eager", device="cpu")
    assert ix.engine == "scalar" and ix.maintenance == "eager"
    assert not ix.capability.map_mode and not ix.collect_stats
    with pytest.raises(CapabilityError):
        ix.lookup([5])
    if ix.capability.successor:
        fs, sc = ix.successor([6])
        assert bool(fs[0]) and int(sc[0]) == 9
    else:
        with pytest.raises(CapabilityError):
            ix.successor([6])
    with pytest.raises(ValueError, match="supports engines"):
        make_index(backend, initial=[5, 9], engine="lockstep", device="cpu")
    with pytest.raises(ValueError, match="maintenance"):
        make_index(backend, initial=[5, 9], maintenance="deferred",
                   device="cpu")
    assert make_index(backend, device="cpu").size() == 0


def test_cfg_carried_policy_refused_where_jax_refuses():
    """A policy that a prebuilt ``cfg=`` carries into a backend that does
    not declare its kind raises ``ValueError`` in JAX's ``make_index`` and
    in the port's, for the same call.  No built-in backend reaches that
    check (``deltatree`` and ``forest`` take every kind; the baselines'
    configs carry no policy), so each side registers the same
    ``deltatree`` entry declared eager-only; on the built-in ``deltatree``
    both sides accept the same ``cfg=``."""
    import dataclasses

    from repro.api import registry as JR
    from repro.core.deltatree import TreeConfig as JTreeConfig
    from repro_torch.api import registry as TR

    name = "deltatree_eager_only"
    kw = dict(height=4, max_dnodes=64)
    for reg in (JR, TR):
        reg.register_backend(dataclasses.replace(
            reg.get_backend("deltatree"), name=name,
            maintenance=("eager",)), overwrite=True)
    try:
        assert TR.supported_maintenance(name) == \
            JR.supported_maintenance(name) == ("eager",)
        for policy in ("deferred", "budgeted:2"):
            with pytest.raises(ValueError, match="config names maintenance"):
                JR.make_index(name, initial=[1, 2, 3],
                              cfg=JTreeConfig(maintenance=policy, **kw))
            with pytest.raises(ValueError, match="config names maintenance"):
                TR.make_index(name, initial=[1, 2, 3], device="cpu",
                              cfg=TDT.TreeConfig(maintenance=policy, **kw))
        jix = JR.make_index(name, initial=[1, 2, 3], cfg=JTreeConfig(**kw))
        tix = TR.make_index(name, initial=[1, 2, 3], device="cpu",
                            cfg=TDT.TreeConfig(**kw))
        assert jix.maintenance == tix.maintenance == "eager"
    finally:
        for reg in (JR, TR):
            reg._REGISTRY.pop(name, None)
    jix = JR.make_index("deltatree", initial=[1, 2, 3],
                        cfg=JTreeConfig(maintenance="budgeted:2", **kw))
    tix = TR.make_index("deltatree", initial=[1, 2, 3], device="cpu",
                        cfg=TDT.TreeConfig(maintenance="budgeted:2", **kw))
    assert jix.maintenance == tix.maintenance == "budgeted:2"
