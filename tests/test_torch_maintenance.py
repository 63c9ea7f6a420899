"""PyTorch port: the relaxed maintenance policies (``deferred``,
``budgeted:K``) equal the JAX scheduler bit for bit — all 16 arena arrays,
the per-op results and ``MaintenanceStats`` after every batch and after
``flush`` — and the reads that only such trees reach (the buffer probe in
SEARCHNODE, the buffered successor fold) equal the JAX engines and the
oracle.  Map-mode legs run the JAX side with x64 in a subprocess."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import deltatree as JDT
from repro.core.oracle import SetOracle
from repro_torch.core import deltatree as TDT

from _subproc import run_py
from _torch_parity import (
    assert_cols_equal,
    assert_trees_equal,
    few_jax_executables,  # noqa: F401  (autouse)
    port_cfg,
)

KEY_HI = 300


def _check_reads(jcfg, jt, cfg, tt, oracle, rng):
    """search (found, hops) and successor equal JAX and the oracle."""
    q = rng.integers(1, KEY_HI + 5, 32).astype(np.int32)
    want = JDT.search_batch(jcfg, jt, jnp.asarray(q))
    got = TDT.search_batch(cfg, tt, q)
    assert_cols_equal(want, got, ("found", "hops"))
    np.testing.assert_array_equal(got[0].numpy(), oracle.snapshot_search(q))
    want = JDT.successor_batch(jcfg, jt, jnp.asarray(q))
    got = TDT.successor_batch(cfg, tt, q)
    assert_cols_equal(want, got, ("found", "succ"))
    live = oracle.keys()
    idx = np.searchsorted(live, q, side="right")
    ef = idx < live.size
    np.testing.assert_array_equal(got[0].numpy(), ef)
    np.testing.assert_array_equal(got[1].numpy()[ef], live[idx[ef]])


def _policy_trace(policy, engine, *, buf_cap=8, steps=6, seed=31,
                  max_dnodes=512, n_init=80, kinds_pool=(0, 1, 1, 2)):
    """JAX and port trees driven through the same batches under
    ``policy``; results, stats, all 16 arrays and reads are held equal
    after every batch and after flush.  Returns the port's (stats,
    free_top) after each batch."""
    rng = np.random.default_rng(seed)
    read_rng = np.random.default_rng(seed + 1)
    jcfg = JDT.TreeConfig(height=4, max_dnodes=max_dnodes, buf_cap=buf_cap,
                          engine=engine, maintenance=policy)
    cfg = port_cfg(jcfg)
    init = np.unique(rng.integers(1, KEY_HI, n_init)).astype(np.int32)
    jt = JDT.bulk_build(jcfg, init)
    tt = TDT.bulk_build(cfg, init, device="cpu")
    oracle = SetOracle(init)
    seen = []
    for step in range(steps):
        kinds = rng.choice(kinds_pool, 24).astype(np.int32)
        keys = rng.integers(1, KEY_HI, 24).astype(np.int32)
        jt, jres, jst = JDT.update_batch(jcfg, jt, jnp.asarray(kinds),
                                         jnp.asarray(keys))
        tt, tres, tst = TDT.update_batch(cfg, tt, torch.as_tensor(kinds),
                                         torch.as_tensor(keys))
        np.testing.assert_array_equal(tres.numpy(),
                                      oracle.apply_updates(kinds, keys))
        np.testing.assert_array_equal(np.asarray(jres), tres.numpy())
        assert jst.asdict() == tst._asdict(), (step, jst.asdict())
        assert_trees_equal(jt, tt, f"{policy} step {step}")
        _check_reads(jcfg, jt, cfg, tt, oracle, read_rng)
        assert TDT.live_keys(cfg, tt).tolist() == sorted(oracle.s)
        assert not bool(tt.alloc_fail)
        seen.append((tst, int(tt.free_top)))
    jt, jst = JDT.flush(jcfg, jt)
    tt, tst = TDT.flush(cfg, tt)
    assert jst.asdict() == tst._asdict() and tst.pending == 0
    assert_trees_equal(jt, tt, f"{policy} flush")
    _check_reads(jcfg, jt, cfg, tt, oracle, read_rng)
    return seen


@pytest.mark.parametrize("engine", ["lockstep", "scalar"])
@pytest.mark.parametrize("policy", ["deferred", "budgeted:2"])
def test_policy_trace_equals_jax(policy, engine):
    """Mirror of test_maintenance.py::test_policy_trace_matches_oracle on
    the port: every batch equal to the JAX scheduler, buffered items
    carried between batches."""
    seen = _policy_trace(policy, engine)
    assert any(s.pending > 0 for s, _ in seen), "no buffered item carried"


def test_forced_repairs_equal_jax():
    """Small buffers under an insert-heavy deferred trace: full buffers
    block ops, so forced Expand sweeps run inside the batch — still equal
    to JAX, array for array."""
    seen = _policy_trace("deferred", "lockstep", buf_cap=2, steps=5, seed=7,
                         kinds_pool=(1, 1, 1, 2))
    assert any(s.expands > 0 for s, _ in seen), "no forced repair ran"
    assert any(s.rounds > 1 for s, _ in seen)


def test_budgeted_respects_repair_budget():
    """Mirror of test_maintenance.py::test_budgeted_respects_repair_budget:
    with roomy buffers budgeted:1 does at most one Rebalance/Merge per
    batch, carries the rest, and equals JAX batch for batch."""
    seen = _policy_trace("budgeted:1", "lockstep", buf_cap=64, steps=6,
                         seed=36, kinds_pool=(1,))
    assert all(s.rebuilds + s.merges <= 1 for s, _ in seen)
    assert any(s.pending > 0 for s, _ in seen)


def test_budgeted_merge_under_freelist_pressure_equals_jax():
    """Delete-heavy budgeted trace on an arena with 4 free ΔNodes, below
    the low-water mark (max_dnodes // 8 free slots): Merge candidates are
    ranked by the slots their splice reclaims."""
    seen = _policy_trace("budgeted:3", "lockstep", max_dnodes=36, n_init=100,
                         steps=5, seed=3, kinds_pool=(2, 2, 2, 1))
    assert any(free < 36 // 8 for _, free in seen)
    assert sum(s.merges for s, _ in seen) > 0


def test_deferred_flush_bit_identical_to_eager():
    """Mirror of test_maintenance.py::test_deferred_flush_bit_identical_to_
    eager: with roomy buffers a deferred batch takes one round, and
    ``flush(budget=min(K, 64))`` reproduces the eager tree of both
    packages bit for bit."""
    kw = dict(height=4, max_dnodes=512, buf_cap=64)
    jcfg = JDT.TreeConfig(**kw)
    cfg_e = port_cfg(jcfg)
    cfg_d = TDT.TreeConfig(**kw, maintenance="deferred")
    rng = np.random.default_rng(35)
    init = np.unique(rng.integers(1, KEY_HI, 60)).astype(np.int32)
    jt = JDT.bulk_build(jcfg, init)
    t_e = TDT.bulk_build(cfg_e, init, device="cpu")
    t_d = TDT.bulk_build(cfg_d, init, device="cpu")
    for step in range(4):
        kinds = rng.integers(1, 3, size=24).astype(np.int32)
        keys = rng.integers(1, KEY_HI, size=24).astype(np.int32)
        jt, jres, _ = JDT.update_batch(jcfg, jt, jnp.asarray(kinds),
                                       jnp.asarray(keys))
        t_e, res_e, _ = TDT.update_batch(cfg_e, t_e, kinds, keys)
        t_d, res_d, st_d = TDT.update_batch(cfg_d, t_d, kinds, keys)
        assert torch.equal(res_e, res_d) and st_d.rounds == 1
        np.testing.assert_array_equal(np.asarray(jres), res_d.numpy())
        t_d, _ = TDT.flush(cfg_d, t_d, min(24, 64))
        assert_trees_equal(jt, t_d, f"flushed step {step}")
        assert_trees_equal(jt, t_e, f"eager step {step}")


def test_deferred_buffered_reads_both_engines():
    """Mirror of test_maintenance.py::test_deferred_buffered_live_deleted_
    reads: buffered keys are found (the SEARCHNODE buffer probe), deleted
    keys are not, successors see buffered keys (the buffered-floor fold) —
    both engines equal to JAX, hops included."""
    import dataclasses

    jcfg = JDT.TreeConfig(height=4, max_dnodes=512, buf_cap=8,
                          maintenance="deferred")
    cfg = port_cfg(jcfg)
    rng = np.random.default_rng(33)
    init = np.unique(rng.integers(1, KEY_HI, 90)).astype(np.int32)
    jt = JDT.bulk_build(jcfg, init)
    tt = TDT.bulk_build(cfg, init, device="cpu")
    oracle = SetOracle(init)
    for _ in range(6):
        kinds = rng.integers(1, 3, size=24).astype(np.int32)
        keys = rng.integers(1, KEY_HI, size=24).astype(np.int32)
        jt, _, _ = JDT.update_batch(jcfg, jt, jnp.asarray(kinds),
                                    jnp.asarray(keys))
        tt, _, st = TDT.update_batch(cfg, tt, kinds, keys)
        oracle.apply_updates(kinds, keys)
    assert st.pending > 0
    assert_trees_equal(jt, tt, "deferred")
    buffered = {k for k in tt.buf.flatten().tolist() if k}
    assert buffered and buffered <= oracle.s
    deleted = sorted(set(range(1, KEY_HI)) - oracle.s)[:10]
    q = np.asarray(sorted(buffered) + sorted(oracle.s - buffered)[:10]
                   + deleted, np.int32)
    probes = np.asarray([k - 1 for k in sorted(buffered)], np.int32)
    for engine in ("scalar", "lockstep"):
        jc = dataclasses.replace(jcfg, engine=engine)
        tc = dataclasses.replace(cfg, engine=engine)
        got = TDT.lookup_batch(tc, tt, q)
        assert_cols_equal(JDT.lookup_batch(jc, jt, jnp.asarray(q)), got,
                          ("found", "payload", "hops"), engine)
        np.testing.assert_array_equal(got[0].numpy(),
                                      [k in oracle.s for k in q])
        got = TDT.successor_batch(tc, tt, probes)
        assert_cols_equal(JDT.successor_batch(jc, jt, jnp.asarray(probes)),
                          got, ("found", "succ"), engine)
        np.testing.assert_array_equal(got[1].numpy(), sorted(buffered))


def test_deferred_map_mode_equals_jax():
    """Map mode under deferred (the JAX side needs x64): arrays, results
    and stats after every batch; lookups return buffered items' payloads;
    scans merge them, on both engines."""
    code = r'''
import dataclasses, json, numpy as np, jax.numpy as jnp, torch
import sys; sys.path.insert(0, "tests")
from _torch_parity import assert_cols_equal, assert_trees_equal, port_cfg
from repro.core import deltatree as JDT
from repro_torch.core import deltatree as TDT
bits = 6
jcfg = JDT.TreeConfig(height=4, max_dnodes=512, buf_cap=8, payload_bits=bits,
                      maintenance="deferred", engine="lockstep")
cfg = port_cfg(jcfg)
rng = np.random.default_rng(34)
init = np.unique(rng.integers(1, 300, 70)).astype(np.int32)
pays = rng.integers(0, 2**bits, init.size).astype(np.int32)
jt = JDT.bulk_build(jcfg, init, pays)
tt = TDT.bulk_build(cfg, init, pays, device="cpu")
expect = dict(zip(init.tolist(), pays.tolist()))
pending = 0
for step in range(5):
    kinds = rng.integers(1, 3, 20).astype(np.int32)
    keys = rng.integers(1, 300, 20).astype(np.int32)
    vals = rng.integers(0, 2**bits, 20).astype(np.int32)
    jt, jres, jst = JDT.update_batch(jcfg, jt, jnp.asarray(kinds),
                                     jnp.asarray(keys), jnp.asarray(vals))
    tt, tres, tst = TDT.update_batch(cfg, tt, kinds, keys, vals)
    np.testing.assert_array_equal(np.asarray(jres), tres.numpy())
    assert jst.asdict() == tst._asdict()
    assert_trees_equal(jt, tt, f"step {step}")
    for kk, ky, pp, rr in zip(kinds, keys, vals, tres.numpy()):
        if kk == 1 and rr:
            expect[int(ky)] = int(pp)
        elif kk == 2 and rr:
            expect.pop(int(ky), None)
    pending = max(pending, tst.pending)
q = np.asarray(sorted(expect), np.int32)
lo = rng.integers(0, 300, 16).astype(np.int32)
hi = (lo + rng.integers(1, 80, 16)).astype(np.int32)
for engine in ("scalar", "lockstep"):
    jc = dataclasses.replace(jcfg, engine=engine)
    tc = dataclasses.replace(cfg, engine=engine)
    got = TDT.lookup_batch(tc, tt, q)
    assert_cols_equal(JDT.lookup_batch(jc, jt, jnp.asarray(q)), got,
                      ("found", "payload", "hops"), engine)
    assert got[0].all() and got[1].tolist() == [expect[int(k)] for k in q]
    got = TDT.scan_batch(tc, tt, lo, hi, 8)
    assert_cols_equal(JDT.scan_batch(jc, jt, jnp.asarray(lo), jnp.asarray(hi),
                                     8), got, ("out", "n", "hops", "more"),
                      engine)
print(json.dumps({"ok": True, "pending": pending}))
'''
    out = run_py(code, x64=True, timeout=300)
    res = json.loads(out.strip().splitlines()[-1])
    assert res["ok"] and res["pending"] > 0
