"""PyTorch port: a per-lane model of the range-scan kernel's loop
(``src/repro_torch/kernels/csrc/veb_scan.cu``) equals the plain version
``ref_delta_scan_fused`` bit for bit.

The CUDA kernel cannot run on the CPU, so its lane algorithm is written out
here in Python and held against the round-by-round plain version (and, on
one tree, against the JAX package's ``ref_delta_scan_fused``):

* one walk per emitted item: the VERIFY pass of a candidate and the FIND
  pass that follows it walk the same query from the same root, so one walk
  settles both, and ``hops`` counts its length twice;
* restarts where the path diverges: a stack of the last path's ΔNodes
  (each with the smallest internal router above the query on its path and
  the fold of the ΔNodes above it) lets the next pass start at the first
  ΔNode whose descent tells the two queries apart, else at the deepest
  ΔNode held (on a path deeper than the stack, its last entry);
* ``hops`` reckoned, not walked, and a round cap that cuts a lane inside
  either pass kind exactly where the plain version stops.

Trees: churned (bulk build, then eager update batches that leave
tombstones) at heights 3-8 in set and map mode, a deep tree of ascending
inserts whose paths overflow the stack, per-lane roots at non-root
ΔNodes, sentinel lanes, empty bands (hi <= start) and every cap from 1 to
the largest lane's need.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import (
    deep_tree,
    few_jax_executables,  # noqa: F401  (autouse)
)
from repro.kernels import ref as JREF
from repro_torch.core import deltatree as DT
from repro_torch.core import layout
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF

SCAN = ("out", "n", "hops", "more")
STACK = 32      # kStack in csrc/veb_scan.cu: one path entry a warp lane
KEY_HI = 4000


def _top(dtype) -> int:
    return int(np.iinfo(np.int64 if dtype == torch.int64 else np.int32).max)


class _Arena:
    """A tree's arrays as numpy, read the way the kernel reads them: a
    ΔNode row in BFS order (the kernel stages it so in shared memory)."""

    def __init__(self, value, mark, child, height):
        self.value, self.mark, self.child = (value.numpy(), mark.numpy(),
                                             child.numpy())
        self.h = height
        self.bottom0 = 1 << (height - 1)
        self.pos = layout.veb_pos_table(height)
        self.m = self.value.shape[0]
        self.big = TREF.walk_big(value.dtype)
        self.top = _top(value.dtype)
        self.walked = 0          # ΔNode descents actually made

    def descend(self, dn, q):
        """The blind descent of ``q`` through ΔNode ``dn``: (lb, lv, rc,
        gt) — the last occupied position and its value, the fold of the
        left-turn routers above it, and the smallest router above ``q`` at
        an internal level (where the query's path turns)."""
        self.walked += 1
        row = self.value[dn]
        b = lb = 1
        lv, rc, gt = 0, self.big, self.top
        for _ in range(self.h):
            x = int(row[self.pos[b]])
            if x != 0:
                if lv != 0 and q < lv < rc:
                    rc = lv
                lb, lv = b, x
            if b < self.bottom0:
                if q < x < gt:
                    gt = x
                b = 2 * b + (1 if q >= x else 0)
        return lb, lv, rc, gt

    def clamp(self, dn):
        return min(max(int(dn), 0), self.m - 1)


def lane_scan(a: _Arena, dn0, start, hi, *, max_out, pmask, max_rounds,
              stack=STACK):
    """One lane of the kernel: (emitted values, n, hops, more)."""
    big = a.big
    out, n, hops, more = [], 0, 0, False
    if start == big or max_rounds <= 0:
        return out, n, hops, more
    entries = [None] * stack        # (dn, gt, fold of the ΔNodes above)

    def walk(q, j, dn, fold, budget):
        depth = j
        while True:
            depth += 1
            if depth > budget:
                return None
            lb, lv, rc, gt = a.descend(dn, q)
            if depth - 1 < stack:
                entries[depth - 1] = (dn, gt, fold)
            fold = min(fold, rc)
            nxt = (int(a.child[dn, lb - a.bottom0]) if lb >= a.bottom0
                   else -1)
            if nxt < 0:
                live = lv != 0 and not a.mark[dn, a.pos[lb]]
                return depth, lv, live, fold
            dn = a.clamp(nxt)

    q, j, dn, fold, verify = start, 0, a.clamp(dn0), big, False
    while True:
        res = walk(q, j, dn, fold, max_rounds - hops)
        if res is None:                      # the cap cuts this pass
            return out, n, max_rounds, more
        length, lv, live, fold = res
        hops += length
        if verify:                           # VERIFY settles
            if live and (lv | pmask) == q:
                if n >= max_out:
                    return out, n, hops, True
                out.append(lv)
                n += 1
            if length > max_rounds - hops:   # the cap cuts the FIND
                return out, n, max_rounds, more
            hops += length                   # the FIND walks the same path
        cand = fold
        if live and q < lv < cand:
            cand = lv
        if cand == big or cand > hi:
            return out, n, hops, more
        qn = cand | pmask
        div = [e for e in range(min(length, stack)) if entries[e][1] <= qn]
        j = div[0] if div else min(length, stack) - 1
        dn, _, fold = entries[j]
        q, verify = qn, True


def model_scan(value, mark, child, roots, starts, his, *, height, max_out,
               pmask, max_rounds, stack=STACK):
    """`lane_scan` over every lane, shaped as `ref_delta_scan_fused`'s
    outputs; also returns the ΔNode descents the model made."""
    a = _Arena(value, mark, child, height)
    k = starts.shape[0]
    out = torch.full((k, max_out), a.big, dtype=value.dtype)
    n = torch.zeros(k, dtype=torch.int32)
    hops = torch.zeros(k, dtype=torch.int32)
    more = torch.zeros(k, dtype=torch.bool)
    for i in range(k):
        row, n[i], hops[i], more[i] = lane_scan(
            a, int(roots[i]), int(starts[i]), int(his[i]), max_out=max_out,
            pmask=pmask, max_rounds=max_rounds, stack=stack)
        out[i, :len(row)] = torch.tensor(row, dtype=value.dtype)
    return (out, n, hops, more), a.walked


def _equal(want, got, where=""):
    for name, a, b in zip(SCAN, want, got):
        assert a.dtype == b.dtype, (where, name)
        assert torch.equal(a, b), (where, name, a, b)


def _tree(height, payload_bits, seed, n_keys=300, batches=3):
    """A port tree on the CPU after bulk build and ``batches`` eager
    update batches of inserts and deletes (deletes leave tombstones)."""
    rng = np.random.default_rng(seed)
    cfg = DT.TreeConfig(height=height, max_dnodes=1024, buf_cap=8,
                        payload_bits=payload_bits, engine="lockstep")
    vals = np.unique(rng.integers(1, KEY_HI, n_keys)).astype(np.int32)
    t = DT.bulk_build(cfg, vals, vals % 97 if payload_bits else None,
                      device="cpu")
    for _ in range(batches):
        kinds = rng.choice([1, 2, 2], 96).astype(np.int32)
        keys = rng.integers(1, KEY_HI, 96).astype(np.int32)
        keys[kinds == 2] = rng.choice(vals, int((kinds == 2).sum()))
        t, _, _ = DT.update_batch(cfg, t, kinds, keys, keys % 97)
    return cfg, t


def _lanes(cfg, t, k, seed):
    """(roots, packed starts, packed his) for ``k`` lanes: narrow and wide
    bands, empty bands (hi <= start), bands past the last key, a start
    below zero (a ``range_scan`` from key 0 passes -1), bands just below a
    tombstoned key, sentinel lanes, and 1 lane in 4 rooted at a live
    non-root ΔNode."""
    rng = np.random.default_rng(seed)
    st = rng.integers(0, KEY_HI, k)
    hi = st + np.where(rng.random(k) < 0.5, rng.integers(1, 40, k),
                       rng.integers(200, 3 * KEY_HI, k))
    hi[:6] = st[:6] - rng.integers(0, 50, 6)
    st[6:9] = KEY_HI + rng.integers(1, 100, 3)
    hi[6:9] = st[6:9] + 500
    st[9] = -5                  # below KEY_MIN - 1: turns left at EMPTY
    tomb = cfg.key_of(t.value[t.mark & t.alive[:, None]]).numpy()
    if tomb.size:
        st[13:21] = rng.choice(tomb, 8) - rng.integers(1, 3, 8)
        hi[13:21] = st[13:21] + rng.integers(5, 300, 8)
    sp = cfg.qpack(torch.as_tensor(st.astype(np.int32)))
    hp = cfg.qpack(torch.as_tensor(np.minimum(hi, layout.KEY_MAX)
                                   .astype(np.int32)))
    sp[10:13] = TREF.walk_big(cfg.vdtype)
    alive = np.flatnonzero(t.alive.numpy())
    roots = np.full(k, int(t.root), np.int32)
    pick = rng.random(k) < 0.25
    roots[pick] = rng.choice(alive, int(pick.sum()))
    return torch.as_tensor(roots), sp.contiguous(), hp.contiguous()


def _both(t, roots, sp, hp, stack=STACK, **kw):
    args = (t.value, t.mark, t.child, roots, sp, hp)
    want = TREF.ref_delta_scan_fused(*args, **kw)
    got, walked = model_scan(*args, stack=stack, **kw)
    return want, got, walked


@pytest.mark.parametrize("stack", [STACK, 2])
@pytest.mark.parametrize("payload_bits", [0, 12])
@pytest.mark.parametrize("height", [3, 4, 5, 6, 7, 8])
def test_lane_model_equals_plain(height, payload_bits, stack):
    """At the full round cap, on churned trees of every height in set and
    map mode, with the kernel's stack and with a two-entry stack (whose
    paths all overflow, so restarts at the root below it are exercised
    on every tree)."""
    cfg, t = _tree(height, payload_bits, seed=10 * height + payload_bits)
    assert bool((t.mark & t.alive[:, None]).any())
    roots, sp, hp = _lanes(cfg, t, 48, seed=height)
    max_out = 12
    cap = TOPS.scan_round_cap(height, cfg.max_dnodes, max_out)
    want, got, walked = _both(t, roots, sp, hp, height=height,
                              max_out=max_out, pmask=cfg.pmask,
                              max_rounds=cap, stack=stack)
    _equal(want, got, (height, payload_bits, stack))
    n, hops, more = got[1], got[2], got[3]
    assert more.any() and (n > 0).any() and (n[:6] == 0).all()
    assert (hops[10:13] == 0).all() and (hops < cap).all()
    if stack == STACK:      # one walk an item, mostly from below the root
        assert walked < int(hops.sum()) // 2


@pytest.mark.parametrize("payload_bits", [0, 12])
@pytest.mark.parametrize("height", [3, 5, 7])
def test_lane_model_every_cap(height, payload_bits):
    """Every cap from 1 to the largest lane's need, on a few lanes with
    several items each: the cut lands inside FIND and VERIFY passes of
    every depth, and the partial rows, ``hops`` and ``more`` still equal
    the plain version's."""
    cfg, t = _tree(height, payload_bits, seed=7 * height + payload_bits)
    roots, sp, hp = _lanes(cfg, t, 24, seed=100 + height)
    keep = torch.tensor([9, 13, 14, 21, 22, 23])   # below 0, tombstone, random
    roots, sp, hp = roots[keep], sp[keep], hp[keep]
    kw = dict(height=height, max_out=6, pmask=cfg.pmask)
    full = TREF.ref_delta_scan_fused(t.value, t.mark, t.child, roots, sp, hp,
                                     max_rounds=10_000, **kw)
    need = int(full[2].max())
    assert need > 4 * height
    for cap in range(1, need + 2):
        want, got, _ = _both(t, roots, sp, hp, max_rounds=cap, **kw)
        _equal(want, got, cap)


@pytest.mark.parametrize("max_out", [1, 10])
@pytest.mark.parametrize("payload_bits", [0, 12])
def test_lane_model_deep_tree_overflows_the_stack(payload_bits, max_out):
    """Paths deeper than the stack: bands among the top keys of a chain
    of ΔNodes longer than 32, so passes restart at the stack's last entry,
    at the full cap and at caps that cut lanes inside the part of a pass
    below the stack; with ``max_out`` 1 most rows fill after one item."""
    cfg, t = deep_tree(payload_bits)
    assert bool((t.mark & t.alive[:, None]).any())
    k = 16
    rng = np.random.default_rng(payload_bits)
    st = rng.integers(560, 600, k).astype(np.int32)
    hi = (st + rng.integers(5, 80, k)).astype(np.int32)
    st[0], hi[0] = 0, layout.KEY_MAX
    roots = t.root.expand(k).contiguous()
    sp, hp = cfg.qpack(torch.as_tensor(st)), cfg.qpack(torch.as_tensor(hi))
    depth = TREF.ref_delta_walk_fused(t.value, t.child, roots, sp, height=3,
                                      max_rounds=10_000)[3]
    assert int(depth[1:].min()) > STACK
    kw = dict(height=3, max_out=max_out, pmask=cfg.pmask)
    for cap in (10_000, STACK + 5, 2 * int(depth.max()) + 7, 500, 1001):
        want, got, _ = _both(t, roots, sp, hp, max_rounds=cap, **kw)
        _equal(want, got, cap)
        assert (got[1] > 0).any()
        assert cap != 10_000 or max_out > 1 or got[3].any()


def test_lane_model_equals_jax_ref():
    """On one churned tree the model equals the JAX package's
    ``ref_delta_scan_fused`` (XLA) too."""
    cfg, t = _tree(5, 0, seed=77)
    roots, sp, hp = _lanes(cfg, t, 48, seed=77)
    kw = dict(height=5, max_out=10, pmask=0, max_rounds=300)
    want = JREF.ref_delta_scan_fused(
        jnp.asarray(t.value.numpy()), jnp.asarray(t.mark.numpy()),
        jnp.asarray(t.child.numpy()), jnp.asarray(roots.numpy()),
        jnp.asarray(sp.numpy()), jnp.asarray(hp.numpy()), **kw)
    got, _ = model_scan(t.value, t.mark, t.child, roots, sp, hp, **kw)
    for name, a, b in zip(SCAN, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    assert int(got[1].sum()) > 0
