"""PyTorch port: the walk kernels' plain versions equal the Pallas kernels
(interpret mode) bit for bit, on churned trees, with sentinel lanes,
per-query roots and the derived round cap, in int32 and int64.  The CUDA
kernels themselves are held against the plain versions on a card by
tests/test_torch_cuda.py."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import deltatree as JDT
from repro.kernels import ops as JOPS
from repro.kernels import veb_search as JVS
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import veb_search as TVS

from _subproc import run_py
from _torch_parity import (
    assert_cols_equal,
    few_jax_executables,  # noqa: F401  (autouse)
    to_port,
)

WALK = ("leaf_val", "leaf_b", "final_dn", "hops", "cand")
ROWS = ("leaf_val", "leaf_b", "next_dn", "cand")


def _churned(h, m, seed, payload_bits=0):
    """A JAX tree after bulk build + two eager update batches (marks, grown
    leaves, expansions), and 256 queries: absent keys, keys above every
    live key, and walk sentinel lanes."""
    rng = np.random.default_rng(seed)
    cfg = JDT.TreeConfig(height=h, max_dnodes=m, buf_cap=8,
                         payload_bits=payload_bits)
    vals = np.unique(rng.integers(1, 4000, 300)).astype(np.int32)
    t = JDT.bulk_build(cfg, vals, vals % 97 if payload_bits else None)
    for _ in range(2):
        kinds = rng.choice([1, 1, 2], 96).astype(np.int32)
        keys = rng.integers(1, 4000, 96).astype(np.int32)
        t, _, _ = JDT.update_batch(cfg, t, jnp.asarray(kinds),
                                   jnp.asarray(keys))
    q = rng.integers(1, 4400, 256).astype(np.int32)
    qp = np.array(cfg.qpack(jnp.asarray(q)))
    qp[:5] = JVS.walk_big(cfg.vdtype)
    return cfg, t, qp


def _roots(t, k, seed):
    """Per-query roots: most lanes at the root, some at live non-root
    ΔNodes (a walk may start at any ΔNode)."""
    alive = np.flatnonzero(np.asarray(t.alive))
    rng = np.random.default_rng(seed)
    roots = np.full(k, int(t.root), np.int32)
    pick = rng.random(k) < 0.25
    roots[pick] = rng.choice(alive, int(pick.sum())).astype(np.int32)
    return roots


@pytest.mark.parametrize("h", [4, 5])
def test_walk_fused_plain_equals_pallas(h):
    jcfg, jt, qp = _churned(h, 256, seed=h)
    k = qp.shape[0]
    roots = _roots(jt, k, seed=h)
    cap = jcfg.walk_round_cap
    assert cap == TOPS.walk_round_cap(h, jcfg.max_dnodes)
    vp, cp = JVS.pad_arena(jt.value, jt.child)
    want = JVS.veb_walk_fused(vp, cp, jnp.asarray(roots), jnp.asarray(qp),
                              height=h, q_tile=128, max_rounds=cap,
                              interpret=True)
    tcfg, tt = to_port(jcfg, jt)
    got = TVS.veb_walk_fused(tt.value, tt.child, torch.as_tensor(roots),
                             torch.as_tensor(qp), height=h, max_rounds=cap)
    assert_cols_equal(want, got, WALK, f"h={h}")
    assert (np.asarray(want[3])[:5] == 0).all()       # sentinels born resolved


def test_walk_fused_round_cap_truncates_alike():
    """A cap below the tree depth stops every lane at the same round."""
    jcfg, jt, qp = _churned(4, 256, seed=3)
    roots = np.full(qp.shape[0], int(jt.root), np.int32)
    vp, cp = JVS.pad_arena(jt.value, jt.child)
    want = JVS.veb_walk_fused(vp, cp, jnp.asarray(roots), jnp.asarray(qp),
                              height=4, q_tile=128, max_rounds=1,
                              interpret=True)
    tcfg, tt = to_port(jcfg, jt)
    got = TVS.veb_walk_fused(tt.value, tt.child, torch.as_tensor(roots),
                             torch.as_tensor(qp), height=4, max_rounds=1)
    assert_cols_equal(want, got, WALK)


@pytest.mark.parametrize("h", [4, 5])
def test_walk_rows_plain_equals_pallas(h):
    jcfg, jt, qp = _churned(h, 256, seed=10 + h)
    k = qp.shape[0]
    dn = _roots(jt, k, seed=h)
    vp, cp = JVS.pad_arena(jt.value, jt.child)
    want = JVS.veb_walk_rows(vp[dn], cp[dn], jnp.asarray(qp), height=h,
                             q_tile=128, interpret=True)
    tcfg, tt = to_port(jcfg, jt)
    dnt = torch.as_tensor(dn).long()
    got = TVS.veb_walk_rows(tt.value[dnt], tt.child[dnt],
                            torch.as_tensor(qp), height=h)
    assert_cols_equal(want, got, ROWS, f"h={h}")


@pytest.mark.parametrize("fused", [True, False])
def test_delta_walk_loops_equal_jax(fused):
    """The port's walks (fused / per-round) equal the JAX package's."""
    jcfg, jt, qp = _churned(5, 256, seed=21)
    want = JOPS.delta_walk(jt.value, jt.child, jt.root, jnp.asarray(qp),
                           height=5, q_tile=128, fused=fused, interpret=True)
    tcfg, tt = to_port(jcfg, jt)
    got = TOPS.delta_walk(tt.value, tt.child, tt.root, torch.as_tensor(qp),
                          height=5, fused=fused)
    assert_cols_equal(want, got, WALK, f"fused={fused}")


def test_delta_contains_equals_jax():
    jcfg, jt, qp = _churned(4, 256, seed=5)
    want = JOPS.delta_contains(jt.value, jt.mark, jt.child, jt.buf, jt.root,
                               jnp.asarray(qp), height=4, q_tile=128,
                               interpret=True)
    tcfg, tt = to_port(jcfg, jt)
    got = TOPS.delta_contains(tt.value, tt.mark, tt.child, tt.buf, tt.root,
                              torch.as_tensor(qp), height=4)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_walk_kernels_int64_equal_pallas():
    """Map mode (packed int64 rows; the JAX side needs x64)."""
    code = r'''
import json, numpy as np, jax.numpy as jnp, torch
import sys; sys.path.insert(0, "tests")
from test_torch_kernels import _churned, _roots, WALK, ROWS
from _torch_parity import assert_cols_equal, to_port
from repro.kernels import veb_search as JVS
from repro_torch.kernels import veb_search as TVS
jcfg, jt, qp = _churned(5, 256, seed=31, payload_bits=12)
assert qp.dtype == np.int64
roots = _roots(jt, qp.shape[0], seed=31)
cap = jcfg.walk_round_cap
vp, cp = JVS.pad_arena(jt.value, jt.child)
want = JVS.veb_walk_fused(vp, cp, jnp.asarray(roots), jnp.asarray(qp),
                          height=5, q_tile=128, max_rounds=cap, interpret=True)
tcfg, tt = to_port(jcfg, jt)
got = TVS.veb_walk_fused(tt.value, tt.child, torch.as_tensor(roots),
                         torch.as_tensor(qp), height=5, max_rounds=cap)
assert_cols_equal(want, got, WALK, "fused int64")
want = JVS.veb_walk_rows(vp[roots], cp[roots], jnp.asarray(qp), height=5,
                         q_tile=128, interpret=True)
r = torch.as_tensor(roots).long()
got = TVS.veb_walk_rows(tt.value[r], tt.child[r], torch.as_tensor(qp),
                        height=5)
assert_cols_equal(want, got, ROWS, "rows int64")
print(json.dumps({"ok": True, "hops": int(np.asarray(want[1]).max())}))
'''
    out = run_py(code, x64=True, timeout=300)
    assert json.loads(out.strip().splitlines()[-1])["ok"]


def test_wrappers_reject_other_devices():
    """A tensor that is on neither the CPU nor a card raises: the wrappers
    never pass it to the plain version."""
    v = torch.zeros((4, 15), dtype=torch.int32, device="meta")
    c = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    q = torch.zeros(3, dtype=torch.int32, device="meta")
    r = torch.zeros(3, dtype=torch.int32, device="meta")
    calls = (TREF.ref_delta_walk_fused.calls, TREF.ref_veb_walk_rows.calls)
    with pytest.raises(ValueError, match="unsupported device"):
        TVS.veb_walk_fused(v, c, r, q, height=4, max_rounds=4)
    with pytest.raises(ValueError, match="unsupported device"):
        TVS.veb_walk_rows(v[:3], c[:3], q, height=4)
    assert calls == (TREF.ref_delta_walk_fused.calls,
                     TREF.ref_veb_walk_rows.calls)


def test_plain_versions_count_calls():
    jcfg, jt, qp = _churned(4, 256, seed=2)
    tcfg, tt = to_port(jcfg, jt)
    before = TREF.ref_delta_walk_fused.calls
    launches = TVS.veb_walk_fused.launches
    TOPS.delta_walk(tt.value, tt.child, tt.root, torch.as_tensor(qp),
                    height=4)
    assert TREF.ref_delta_walk_fused.calls == before + 1
    assert TVS.veb_walk_fused.launches == launches   # no kernel on the CPU

