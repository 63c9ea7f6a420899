"""PyTorch port: range scans equal the JAX package bit for bit — the scan
kernel's plain version against the Pallas kernel (interpret mode), with
sentinel lanes, per-lane roots and a round cap that truncates, in int32
and int64; the engines' ``scan`` / ``successor_k`` on both engines; the
Index's ``range_scan`` pages and cursors; and the merge of buffered items
under deferred maintenance (invariant I5').  The CUDA kernel itself is held
against the plain version on a card by tests/test_torch_cuda.py."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.api import OpBatch as JOpBatch
from repro.api import make_index as jmake_index
from repro.core import engine as JE
from repro.core import layout as JL
from repro.core.oracle import SetOracle
from repro.kernels import ops as JOPS
from repro.kernels import veb_search as JVS
from repro_torch.api import OpBatch, ScanCursor, make_index
from repro_torch.core import engine as TE
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import veb_search as TVS

from _subproc import run_py
from _torch_parity import (
    assert_cols_equal,
    few_jax_executables,  # noqa: F401  (autouse)
    to_port,
)
from test_torch_kernels import _churned, _roots

SCAN = ("out", "n", "hops", "more")
KEY_HI = 300


def _bands(k, seed, key_hi=4000):
    """(starts, his) raw keys for ``k`` lanes: sparse and dense bands,
    empty ones (hi <= start), bands past the last key, KEY_MIN - 1 starts
    and the reserved ROUTE_LEFT start (a router pad lane)."""
    rng = np.random.default_rng(seed)
    st = rng.integers(0, key_hi, k).astype(np.int32)
    width = np.where(rng.random(k) < 0.5, rng.integers(1, 40, k),
                     rng.integers(200, 3 * key_hi, k))
    hi = np.minimum(st + width, JL.KEY_MAX).astype(np.int32)
    hi[:6] = st[:6] - rng.integers(0, 50, 6)            # empty bands
    st[6:9] = key_hi + rng.integers(1, 100, 3)          # past the last key
    hi[6:9] = st[6:9] + 500
    st[9], hi[9] = 0, JL.KEY_MAX                        # from KEY_MIN - 1
    st[10:13] = JL.ROUTE_LEFT                           # pad lanes
    return st, hi


def _packed(cfg, st, hi):
    sp = np.array(cfg.qpack(jnp.asarray(st)))
    sp[st == JL.ROUTE_LEFT] = JVS.walk_big(cfg.vdtype)
    return sp, np.array(cfg.qpack(jnp.asarray(hi)))


def _pallas_scan(jt, roots, sp, hp, h, max_out, pmask, cap):
    vp, cp = JVS.pad_arena(jt.value, jt.child)
    mp = jnp.pad(jt.mark, ((0, 0), (0, vp.shape[1] - jt.mark.shape[1])))
    out, n, hops, more = JVS.veb_scan_fused(
        vp, mp, cp, jnp.asarray(roots), jnp.asarray(sp), jnp.asarray(hp),
        height=h, max_out=max_out, pmask=pmask, q_tile=sp.shape[0],
        max_rounds=cap, interpret=True)
    return out[:, :max_out], n, hops, more.astype(bool)


@pytest.mark.parametrize("h,max_out", [(4, 12), (5, 5)])
def test_scan_plain_equals_pallas(h, max_out):
    """The plain version equals the Pallas kernel on a churned tree:
    tombstones, per-lane roots at non-root ΔNodes, sentinel lanes, rows
    that fill (``more``) and rows that do not."""
    jcfg, jt, _ = _churned(h, 256, seed=40 + h)
    st, hi = _bands(64, seed=h)
    sp, hp = _packed(jcfg, st, hi)
    roots = _roots(jt, 64, seed=h)
    cap = TOPS.scan_round_cap(h, jcfg.max_dnodes, max_out)
    assert cap == JOPS.scan_round_cap(h, jcfg.max_dnodes, max_out)
    want = _pallas_scan(jt, roots, sp, hp, h, max_out, 0, cap)
    tcfg, tt = to_port(jcfg, jt)
    got = TVS.veb_scan_fused(tt.value, tt.mark, tt.child,
                             torch.as_tensor(roots), torch.as_tensor(sp),
                             torch.as_tensor(hp), height=h, max_out=max_out,
                             pmask=0, max_rounds=cap)
    assert_cols_equal(want, got, SCAN, f"h={h}")
    n, more = got[1].numpy(), got[3].numpy()
    assert (n[10:13] == 0).all() and (got[2].numpy()[10:13] == 0).all()
    assert more.any() and (n == max_out).any() and (n[:6] == 0).all()


def test_scan_round_cap_truncates_alike():
    """A cap that stops lanes mid-scan leaves the same partial rows (and
    ``more`` False) in both packages."""
    jcfg, jt, _ = _churned(4, 256, seed=44)
    st, hi = _bands(64, seed=9)
    sp, hp = _packed(jcfg, st, hi)
    roots = np.full(64, int(jt.root), np.int32)
    want = _pallas_scan(jt, roots, sp, hp, 4, 12, 0, 40)
    tcfg, tt = to_port(jcfg, jt)
    got = TOPS.delta_scan(tt.value, tt.mark, tt.child, tt.root,
                          torch.as_tensor(sp), torch.as_tensor(hp), height=4,
                          max_out=12, max_rounds=40)
    assert_cols_equal(want, got, SCAN)
    assert (got[2].numpy() == 40).any() and not got[3].any()


def test_scan_kernels_int64_equal_pallas():
    """Map mode (packed int64 rows, pmask 4095; the JAX side needs x64):
    the plain version against the Pallas kernel, and the lockstep engine
    scan of the two packages."""
    code = r'''
import json, numpy as np, jax.numpy as jnp, torch
import sys; sys.path.insert(0, "tests")
from test_torch_scan import _bands, _packed, _pallas_scan, SCAN
from test_torch_kernels import _churned, _roots
from _torch_parity import assert_cols_equal, to_port
from repro.core import engine as JE
from repro.kernels import ops as JOPS
from repro_torch.core import engine as TE
from repro_torch.kernels import veb_search as TVS
import dataclasses
jcfg, jt, _ = _churned(5, 256, seed=46, payload_bits=12)
st, hi = _bands(64, seed=46)
sp, hp = _packed(jcfg, st, hi)
assert sp.dtype == np.int64
roots = _roots(jt, 64, seed=46)
cap = JOPS.scan_round_cap(5, 256, 10)
want = _pallas_scan(jt, roots, sp, hp, 5, 10, 4095, cap)
tcfg, tt = to_port(jcfg, jt)
got = TVS.veb_scan_fused(tt.value, tt.mark, tt.child, torch.as_tensor(roots),
                         torch.as_tensor(sp), torch.as_tensor(hp), height=5,
                         max_out=10, pmask=4095, max_rounds=cap)
assert_cols_equal(want, got, SCAN, "kernel int64")
jl = dataclasses.replace(jcfg, engine="lockstep")
want = JE.scan(jl, jt, jnp.asarray(st), jnp.asarray(hi), max_out=10)
got = TE.scan(dataclasses.replace(tcfg, engine="lockstep"), tt, st, hi,
              max_out=10)
assert_cols_equal(want, got, SCAN, "engine int64")
print(json.dumps({"ok": True, "emitted": int(np.asarray(want[1]).sum())}))
'''
    out = run_py(code, x64=True, timeout=300)
    res = json.loads(out.strip().splitlines()[-1])
    assert res["ok"] and res["emitted"] > 0


@pytest.mark.parametrize("engine", ["scalar", "lockstep"])
def test_engine_scan_and_successor_k_equal_jax(engine):
    """`engine.scan` and `engine.successor_k` equal the JAX engines on a
    churned eager tree, pad lanes and empty bands included; the lockstep
    scan launches nothing on the CPU and runs the plain version once."""
    import dataclasses

    jcfg, jt, _ = _churned(4, 256, seed=47)
    jcfg = dataclasses.replace(jcfg, engine=engine)
    tcfg, tt = to_port(jcfg, jt)
    st, hi = _bands(48, seed=47)
    calls = TREF.ref_delta_scan_fused.calls
    launches = TVS.veb_scan_fused.launches
    got = TE.scan(tcfg, tt, st, hi, max_out=9)
    assert TREF.ref_delta_scan_fused.calls == calls + (engine == "lockstep")
    assert TVS.veb_scan_fused.launches == launches
    want = JE.scan(jcfg, jt, jnp.asarray(st), jnp.asarray(hi), max_out=9)
    assert_cols_equal(want, got, SCAN, engine)
    q = st[12:]
    assert_cols_equal(JE.successor_k(jcfg, jt, jnp.asarray(q), 6),
                      TE.successor_k(tcfg, tt, q, 6), SCAN, "successor_k")


def test_range_scan_pages_equal_jax_and_oracle():
    """`Index.range_scan` pages and cursors, and `Index.successor_k`, equal
    the JAX Index and the oracle; chaining cursors replays `live_items`."""
    rng = np.random.default_rng(43)
    init = np.unique(rng.integers(1, KEY_HI, 70)).astype(np.int32)
    kw = dict(height=4, max_dnodes=512, buf_cap=8, engine="lockstep")
    tix = make_index("deltatree", initial=init, device="cpu", **kw)
    jix = jmake_index("deltatree", initial=init, **kw)
    got, cursor, pages = [], None, 0
    while True:
        if cursor is None:
            res = tix.range_scan(1, KEY_HI + 5, max_items=7)
            jres = jix.range_scan(1, KEY_HI + 5, max_items=7)
        else:
            res = tix.range_scan(0, 0, max_items=7, cursor=cursor)
            jres = jix.range_scan(0, 0, max_items=7, cursor=cursor)
        assert res.items() == jres.items() and res.cursor == jres.cursor
        got.extend(res.keys.tolist())
        pages += 1
        if res.cursor is None:
            break
        assert isinstance(res.cursor, ScanCursor) and res.more
        cursor = res.cursor
    assert got == [k for k, _ in tix.live_items()] == init.tolist()
    assert pages == -(-init.size // 7)
    for _ in range(6):
        lo = int(rng.integers(1, KEY_HI))
        hi = int(rng.integers(lo, KEY_HI + 5))
        res = tix.range_scan(lo, hi, max_items=5)
        band = init[(init >= lo) & (init <= hi)]
        np.testing.assert_array_equal(res.keys, band[:5])
        assert res.more == (band.size > 5)
    q = rng.integers(0, KEY_HI, 16).astype(np.int32)
    assert_cols_equal(jix.successor_k(jnp.asarray(q), 4),
                      tix.successor_k(q, 4),
                      ("keys", "payloads", "n", "hops", "more"))


@pytest.mark.parametrize("engine", ["scalar", "lockstep"])
def test_scan_deferred_merges_buffered_items(engine):
    """Deferred maintenance carries inserts in overflow buffers (I5');
    scans still return them, merged into key order, equal to the JAX
    package and to the oracle (mirror of
    test_scan.py::test_scan_deferred_merges_buffered_items)."""
    rng = np.random.default_rng(46)
    init = np.unique(rng.integers(1, KEY_HI, 60)).astype(np.int32)
    kw = dict(height=4, max_dnodes=512, buf_cap=8, engine=engine,
              maintenance="deferred")
    tix = make_index("deltatree", initial=init, device="cpu", **kw)
    jix = jmake_index("deltatree", initial=init, **kw)
    oracle = SetOracle(init)
    saw_pending = False
    for _ in range(5):
        kinds = rng.integers(0, 3, size=20).astype(np.int32)
        keys = rng.integers(1, KEY_HI, size=20).astype(np.int32)
        tix, _, stats = tix.update(OpBatch.mixed(kinds, keys))
        jix, _, _ = jix.update(JOpBatch.mixed(kinds, keys))
        oracle.apply_updates(kinds, keys)
        saw_pending |= stats.pending > 0
        lo = rng.integers(0, KEY_HI, size=10).astype(np.int32)
        hi = (lo + rng.integers(1, 100, size=10)).astype(np.int32)
        got = tix.spec.backend.scan(tix.spec.cfg, tix.state, lo, hi, 12)
        want = jix.spec.backend.scan(jix.spec.cfg, jix.state, jnp.asarray(lo),
                                     jnp.asarray(hi), 12)
        assert_cols_equal(want, got, ("keys", "payloads", "n", "hops",
                                      "more"))
        live = oracle.keys()
        for i in range(10):
            band = live[(live > lo[i]) & (live <= hi[i])]
            n = int(got[2][i])
            np.testing.assert_array_equal(got[0][i, :n].numpy(), band[:12])
            assert bool(got[4][i]) == (band.size > 12)
    assert saw_pending, "trace never exercised carried buffers"


def test_deferred_scan_below_start_reference_fault():
    """A reference fault, mirrored bit for bit: under a non-eager policy a
    band whose hi lies below its start, with buffered items between the
    two, merges a *negative* buffered count, so ``n`` goes below 0 and
    ``Index.range_scan(lo, hi)`` with ``lo > hi + 1`` returns zero keys
    (engine._merge_buffered_lane in both packages; ROADMAP.md Queue 3)."""
    rng = np.random.default_rng(46)
    init = np.unique(rng.integers(1, KEY_HI, 60)).astype(np.int32)
    kw = dict(height=4, max_dnodes=512, buf_cap=8, maintenance="deferred")
    tix = make_index("deltatree", initial=init, device="cpu", **kw)
    jix = jmake_index("deltatree", initial=init, **kw)
    for _ in range(5):
        kinds = rng.integers(0, 3, size=20).astype(np.int32)
        keys = rng.integers(1, KEY_HI, size=20).astype(np.int32)
        tix, _ = tix.insert_delete(OpBatch.mixed(kinds, keys))
        jix, _ = jix.insert_delete(JOpBatch.mixed(kinds, keys))
    buffered = sorted(k for k in tix.state.buf.flatten().tolist() if k)
    b = buffered[len(buffered) // 2]
    res, jres = (ix.range_scan(b + 6, b - 5, max_items=8) for ix in (tix, jix))
    assert res.items() == jres.items() == [(0, 0)] * 7
