"""PyTorch port: a per-lane model of the walk kernels' loops
(``src/repro_torch/kernels/csrc/veb_walk.cu``) equals the plain versions
``ref_delta_walk_fused`` / ``ref_veb_walk_rows`` bit for bit.

The CUDA kernels cannot run on the CPU, so their lane algorithm is written
out here in Python and held against the level-by-level plain versions (and
against the JAX package's Pallas kernels in interpret mode):

* a ΔNode row is read by vEB pieces (`piece_plan`): the pieces a path
  crosses, each a contiguous storage run of at most 15 slots that a lane
  loads in one round trip and descends through in registers; with the
  last piece come the child ids of its leaves;
* the fused kernel stages the root ΔNode of each block's first lane in
  shared memory, so a lane reads that ΔNode without a round trip; the
  kernels are built for every block size in ``BlockSizes`` (32-256), and
  the staged root is only a cache, so each size gives the same bits;
* ``veb_walk_rows`` stops at the first node whose left child is EMPTY; at
  a piece boundary that child is the root of the next piece or of its
  sibling, loaded together with the piece the router picks;
* above height 12 (the tall path, up to 30) the position table stays in
  global memory, so each piece costs one more round trip, and the fused
  kernel stages no root: every row is read in place; the plan
  (``veb::piece_plan``, 64 bits) crosses up to 8 pieces.

Trees: churned (bulk build, then eager update batches that leave
tombstones) at heights 3-16 in set and map mode, and random arenas at
every height 1-12 (heights 1 and 2 build no tree: a ΔNode holds at most
two leaves there); sentinel lanes, per-lane roots at non-root ΔNodes and
every round cap from 1 to the largest lane's need.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import veb_search as JVS
from repro_torch.core import deltatree as DT
from repro_torch.core import layout
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import veb_search as VS

WALK = ("leaf_val", "leaf_b", "final_dn", "hops", "cand")
ROWS = ("leaf_val", "leaf_b", "next_dn", "cand")
PIECE = 4       # kPiece in csrc/veb_common.cuh
KEY_HI = 40_000
SOURCE = (Path(__file__).resolve().parents[1]
          / "src/repro_torch/kernels/csrc/veb_walk.cu")


def block_sizes() -> tuple:
    """``BlockSizes`` in csrc/veb_walk.cu: the block sizes the kernels are
    built for (the lanes of a block share a staged root); the wrapper's
    ``BLOCK_SIZES`` must list the same."""
    m = re.search(r"using BlockSizes = Sizes<([\d, ]+)>;", SOURCE.read_text())
    assert m, "BlockSizes not found in veb_walk.cu"
    sizes = tuple(int(x) for x in m.group(1).split(","))
    assert sizes == VS.BLOCK_SIZES and VS.DEFAULT_BLOCK in sizes
    return sizes


def piece_plan(h: int) -> list:
    """veb::piece_plan: the heights of the pieces a path crosses, top
    first — `layout.veb_order`'s split (top h // 2, bottom h - h // 2),
    split again until a piece has height <= PIECE."""
    if h <= PIECE:
        return [h]
    return [p for x in (h // 2, h - h // 2) for p in piece_plan(x)]


def cuda_piece_plan(h: int) -> list:
    """veb::piece_plan as csrc/veb_common.cuh computes it — halves,
    quarters, then pieces of <= PIECE, 4 bits a piece and the count from
    bit 32 of a 64-bit word — decoded."""
    if h <= PIECE:
        plan = h | 1 << 32
    else:
        plan = n = 0
        for x in (h // 2, h - h // 2):
            parts = [x] if x <= PIECE else [
                p for y in (x // 2, x - x // 2)
                for p in ([y] if y <= PIECE else [y // 2, y - y // 2])]
            for p in parts:
                plan |= p << (4 * n)
                n += 1
        plan |= n << 32
    assert plan < 1 << 64
    return [(plan >> (4 * q)) & 15 for q in range(plan >> 32)]


def piece_pos(p: int, j: int) -> int:
    """veb::piece_pos: the storage offset of local BFS node j in a piece
    of height p <= 4 (its top and its bottoms are BFS-ordered)."""
    d = j.bit_length() - 1
    ht, hb = p // 2, p - p // 2
    if d < ht:
        return j - 1
    sub = j >> (d - ht)
    local = (1 << (d - ht)) + j - (sub << (d - ht))
    return (1 << ht) - 1 + (sub - (1 << ht)) * ((1 << hb) - 1) + local - 1


class _Arena:
    """A tree's arrays as numpy, read the way the kernels read them: a
    piece at a time from the storage-order row, counting the round trips
    to device memory (a staged row costs none; above height 12 the piece
    root's position is one more, read from the table in global memory,
    and no root is staged)."""

    def __init__(self, value, child, height):
        self.value, self.child = value.numpy(), child.numpy()
        self.h = height
        self.tall = height > VS.SMEM_HEIGHT
        self.stages = not self.tall
        self.bottom0 = 1 << (height - 1)
        self.pos = layout.veb_pos_table(height)
        self.plan = piece_plan(height)
        self.m = self.value.shape[0]
        self.big = TREF.walk_big(value.dtype)
        self.trips = 0

    def clamp(self, dn):
        return min(max(int(dn), 0), self.m - 1)

    def load(self, row, crow, root, p, last, staged):
        """The piece of height p rooted at BFS node `root`: its slots by
        local BFS index, and with the last piece its leaves' child ids."""
        base = int(self.pos[root])
        run = row[base:base + (1 << p) - 1]
        r = {j: int(run[piece_pos(p, j)]) for j in range(1, 1 << p)}
        c = None
        if last:
            c0 = (root << (p - 1)) - self.bottom0
            c = [int(x) for x in crow[c0:c0 + (1 << (p - 1))]]
        self.trips += (1 if self.tall else 0) + (0 if staged else 1)
        return r, c

    def fused_round(self, dn, v, staged):
        """One round of the fused kernel through ΔNode dn: (lb, lv, rc,
        nxt) — the last occupied node and its value, the fold of the
        left-turn routers above it, the child to hop to (-1: none)."""
        row, crow = self.value[dn], self.child[dn]
        b = lb = 1
        lv, rc, nxt = 0, self.big, -1
        for q, p in enumerate(self.plan):
            last = q == len(self.plan) - 1
            root = b
            r, c = self.load(row, crow, root, p, last, staged)
            j = 1
            for _ in range(p):
                x = r[j]
                if x != 0:
                    if lv != 0 and v < lv < rc:
                        rc = lv
                    lb, lv = b, x
                if b < self.bottom0:
                    go = 1 if v >= x else 0
                    b, j = 2 * b + go, 2 * j + go
            if last and lb >= self.bottom0:
                nxt = c[lb - (root << (p - 1))]
        return lb, lv, rc, nxt

    def rows_walk(self, row, crow, v):
        """`walk_rows_kernel` on one gathered row: (leaf_val, leaf_b,
        next_dn, cand, round trips)."""
        b, x, cand, nxt = 1, 0, self.big, -1
        trips = 0
        for q, p in enumerate(self.plan):
            head, last = q == 0, q == len(self.plan) - 1
            go = 0 if head else (1 if v >= x else 0)
            root = 1 if head else 2 * b + go
            r, c = self.load(row, crow, root, p, last, staged=True)
            trips += 2 if self.tall else 1   # sibling slot in the same trip
            if not head:
                left = int(row[self.pos[2 * b]]) if go else r[1]
                if left == 0:                # b is the leaf
                    return x, b, nxt, cand, trips
                if not go and x < cand:
                    cand = x
                b = root
            j = 1
            for lvl in range(p):
                x = r[j]
                if lvl + 1 < p:
                    if r[2 * j] == 0:
                        return x, b, nxt, cand, trips
                    go = 1 if v >= x else 0
                    if not go and x < cand:
                        cand = x
                    b, j = 2 * b + go, 2 * j + go
            if last:
                if b >= self.bottom0:
                    nxt = c[b - (root << (p - 1))]
                return x, b, nxt, cand, trips
        raise AssertionError("unreachable")


def model_fused(value, child, roots, queries, *, height, max_rounds,
                block=VS.DEFAULT_BLOCK):
    """The fused kernel lane by lane at ``block`` threads a block, shaped
    as `ref_delta_walk_fused`'s outputs; also returns the round trips to
    device memory the lanes made over their rounds (a ΔNode staged for the
    lane's block costs none; a tall root, never staged, costs as much as
    any ΔNode)."""
    a = _Arena(value, child, height)
    k = queries.shape[0]
    out = [np.zeros(k, a.value.dtype), np.ones(k, np.int32),
           roots.numpy().astype(np.int32).copy(), np.zeros(k, np.int32),
           np.full(k, a.big, a.value.dtype)]
    for i in range(k):
        staged_dn = (a.clamp(roots[i // block * block]) if a.stages
                     else None)
        v, dn = int(queries[i]), int(roots[i])
        cand, hops = a.big, 0
        resolved = v == a.big
        for _ in range(max_rounds):
            if resolved:
                break
            dnc = a.clamp(dn)
            lb, lv, rc, nxt = a.fused_round(dnc, v, dnc == staged_dn)
            hops += 1
            cand = min(cand, rc)
            if nxt < 0:
                resolved = True
                out[0][i], out[1][i], out[2][i] = lv, lb, dn
            else:
                dn = nxt
        out[3][i], out[4][i] = hops, cand
    return tuple(torch.as_tensor(x) for x in out), a.trips


def model_rows(rows, childrows, queries, *, height):
    """`walk_rows_kernel` lane by lane, shaped as `ref_veb_walk_rows`'s
    outputs; also returns each lane's round trips."""
    a = _Arena(rows, childrows, height)
    res = [a.rows_walk(a.value[i], a.child[i], int(queries[i]))
           for i in range(queries.shape[0])]
    cols = list(zip(*res))
    return (torch.as_tensor(np.array(cols[0], a.value.dtype)),
            torch.as_tensor(np.array(cols[1], np.int32)),
            torch.as_tensor(np.array(cols[2], np.int32)),
            torch.as_tensor(np.array(cols[3], a.value.dtype))), cols[4]


def _equal(want, got, names, where=""):
    for name, a, b in zip(names, want, got):
        assert a.dtype == b.dtype, (where, name)
        assert torch.equal(a, b), (where, name, a, b)


# keys a tall tree draws: enough for child ΔNodes after the churn
TALL_KEYS = {13: 3000, 14: 6000, 16: 20_000}


def _tree(height, payload_bits, seed, max_dnodes=None):
    """A port tree on the CPU after bulk build and three eager update
    batches of inserts and deletes (deletes leave tombstones, inserts grow
    leaves and child ΔNodes)."""
    rng = np.random.default_rng(seed)
    n_keys = 300 if height < 8 else TALL_KEYS.get(height, 3000)
    max_dnodes = max_dnodes or (2048 if height < 10 else 128)
    key_hi = KEY_HI if n_keys < 10_000 else 5 * KEY_HI
    cfg = DT.TreeConfig(height=height, max_dnodes=max_dnodes,
                        buf_cap=8, payload_bits=payload_bits,
                        engine="lockstep")
    vals = np.unique(rng.integers(1, key_hi, n_keys)).astype(np.int32)
    t = DT.bulk_build(cfg, vals, vals % 97 if payload_bits else None,
                      device="cpu")
    for _ in range(3):
        kinds = rng.choice([1, 1, 2], 256).astype(np.int32)
        keys = rng.integers(1, key_hi, 256).astype(np.int32)
        keys[kinds == 2] = rng.choice(vals, int((kinds == 2).sum()))
        t, _, _ = DT.update_batch(cfg, t, kinds, keys, keys % 97)
    assert not bool(t.alloc_fail)
    return cfg, t


def _lanes(cfg, t, k, seed):
    """(roots, packed queries) for ``k`` lanes: present and absent keys,
    keys above every live key, sentinel lanes, and 1 lane in 4 rooted at
    a live non-root ΔNode."""
    rng = np.random.default_rng(seed)
    q = rng.integers(1, KEY_HI + 1000, k).astype(np.int32)
    live = DT.live_keys(cfg, t)
    half = rng.random(k) < 0.4
    q[half] = rng.choice(live, int(half.sum()))
    qp = cfg.qpack(torch.as_tensor(q))
    qp[:3] = TREF.walk_big(cfg.vdtype)
    alive = np.flatnonzero(t.alive.numpy())
    roots = np.full(k, int(t.root), np.int32)
    pick = rng.random(k) < 0.25
    roots[pick] = rng.choice(alive, int(pick.sum()))
    return torch.as_tensor(roots), qp.contiguous()


def _random_arena(height, dtype, seed, m=24):
    """Rows of random routers over a random occupied top tree of each
    ΔNode (some rows empty, some routers ROUTE_LEFT), child ids that point
    further down the arena or past its end (clamped by the walk) or are
    -1: any arena, not only a maintained tree, walks alike."""
    rng = np.random.default_rng(seed)
    ub, lc = 2 ** height - 1, 2 ** (height - 1)
    pos = layout.veb_pos_table(height)
    big = TREF.walk_big(dtype)
    hi = 1 << 40 if dtype == torch.int64 else big
    value = np.zeros((m, ub), np.int64)
    for d in range(m):
        depth = rng.integers(0, height + 1)
        for b in range(1, 2 ** height):
            if b == 1 and depth or (b.bit_length() <= depth
                                    and rng.random() < 0.85):
                value[d, pos[b]] = rng.integers(1, hi)
        if rng.random() < 0.25:
            value[d, pos[rng.integers(1, 2 ** height)]] = big
    child = rng.integers(0, m + 3, (m, lc))
    child = np.maximum(child, np.arange(m)[:, None] + 1)
    child[rng.random((m, lc)) < 0.5] = -1
    npdt = np.int64 if dtype == torch.int64 else np.int32
    k = 96
    q = rng.integers(1, hi, k)
    q[:2] = big
    roots = rng.integers(-2, m + 2, k)
    roots[: k // 2] = 0
    return (torch.as_tensor(value.astype(npdt)),
            torch.as_tensor(child.astype(np.int32)),
            torch.as_tensor(roots.astype(np.int32)),
            torch.as_tensor(q.astype(npdt)))


def _rows_of(value, child, dn):
    """The rows the per-round walk gathers for ΔNodes dn, padded as a
    caller may pad them."""
    d = dn.clamp(0, value.shape[0] - 1).long()
    k = d.shape[0]
    rows = torch.cat([value[d], torch.zeros(k, 3, dtype=value.dtype)], 1)
    crows = torch.cat([child[d], torch.full((k, 1), -7, dtype=torch.int32)],
                      1)
    return rows.contiguous(), crows.contiguous()


@pytest.mark.parametrize("height", [*range(1, 17), 22])
def test_piece_plan_covers_every_path(height):
    """Every root-to-leaf path of a height-H ΔNode crosses one piece per
    plan entry; each piece is the contiguous storage run
    [pos[root], pos[root] + 2**p - 1) in `piece_pos` order, and the pieces
    hold the path's nodes exactly once (above height 12, 4096 of the
    paths, the first and last among them).  Pieces a ΔNode: 1 / 2 / 4 / 8
    at H = 4 / 7 / 12 / 22."""
    pos = layout.veb_pos_table(height)
    plan = piece_plan(height)
    assert sum(plan) == height and max(plan) <= PIECE
    leaves = range(2 ** (height - 1), 2 ** height)
    if height > VS.SMEM_HEIGHT:
        pick = np.random.default_rng(height).choice(len(leaves), 4096)
        leaves = [leaves[0], leaves[-1], *(leaves[int(i)] for i in pick)]
    for leaf in leaves:
        path = [leaf >> s for s in range(height - 1, -1, -1)]
        depth = 0
        for p in plan:
            root = path[depth]
            for j in range(1, 1 << p):
                d = j.bit_length() - 1
                b = (root << d) + j - (1 << d)
                assert pos[b] == pos[root] + piece_pos(p, j), (leaf, p, j)
            assert sorted(piece_pos(p, j) for j in range(1, 1 << p)) == \
                list(range((1 << p) - 1))
            depth += p
        assert depth == height
    assert len(plan) == {4: 1, 7: 2, 12: 4, 22: 8}.get(height, len(plan))
    assert len(plan) == (1 if height <= 4 else 2 if height <= 8
                         else 3 if height == 9 else 4 if height <= 16
                         else len(plan))


@pytest.mark.parametrize("height", range(1, 31))
def test_cuda_plan_equals_the_split(height):
    """The kernels' 64-bit ``veb::piece_plan`` equals the recursive vEB
    split at every height the kernels take (1-30): at most 8 pieces of
    height <= 4."""
    plan = cuda_piece_plan(height)
    assert plan == piece_plan(height)
    assert len(plan) <= 8 and max(plan) <= PIECE and sum(plan) == height


@pytest.mark.parametrize("payload_bits", [0, 12])
@pytest.mark.parametrize("height", range(1, 13))
def test_lane_model_equals_plain_random_arena(height, payload_bits):
    """Both models on random arenas at every height, in set and map
    dtypes, at several round caps: out-of-range roots and child ids
    clamp, sentinel lanes stay resolved, roots differ inside a block."""
    dtype = torch.int64 if payload_bits else torch.int32
    value, child, roots, q = _random_arena(height, dtype, 100 * height
                                           + payload_bits)
    for cap in (1, 2, 5, 40):
        kw = dict(height=height, max_rounds=cap)
        want = TREF.ref_delta_walk_fused(value, child, roots, q, **kw)
        for block in block_sizes():
            got, _ = model_fused(value, child, roots, q, block=block, **kw)
            _equal(want, got, WALK, (height, cap, block))
    rows, crows = _rows_of(value, child, roots)
    want = TREF.ref_veb_walk_rows(rows, crows, q, height=height)
    got, _ = model_rows(rows, crows, q, height=height)
    _equal(want, got, ROWS, height)


@pytest.mark.parametrize("payload_bits", [0, 12])
@pytest.mark.parametrize("height", [*range(3, 15), 16])
def test_lane_model_equals_plain_every_cap(height, payload_bits):
    """The fused model on churned trees at heights 3-16 (13-16: the tall
    path), set and map mode, at every round cap from 1 to one past the
    largest lane's need; the rows model in every round of the per-round
    walk."""
    cfg, t = _tree(height, payload_bits, seed=10 * height + payload_bits)
    roots, q = _lanes(cfg, t, 64, seed=height)
    full = TREF.ref_delta_walk_fused(t.value, t.child, roots, q,
                                     height=height, max_rounds=1000)
    need = int(full[3].max())
    assert 2 <= need < 1000 and int(full[3][:3].max()) == 0
    for cap in range(1, need + 2):
        kw = dict(height=height, max_rounds=cap)
        want = TREF.ref_delta_walk_fused(t.value, t.child, roots, q, **kw)
        got, _ = model_fused(t.value, t.child, roots, q, **kw)
        _equal(want, got, WALK, cap)
    dn = roots.clone()
    for rnd in range(need):
        rows, crows = _rows_of(t.value, t.child, dn)
        want = TREF.ref_veb_walk_rows(rows, crows, q, height=height)
        got, _ = model_rows(rows, crows, q, height=height)
        _equal(want, got, ROWS, rnd)
        dn = torch.where(want[2] >= 0, want[2], dn)


@pytest.mark.parametrize("height", [5, 9])
def test_lane_model_equals_pallas(height):
    """Both models equal the JAX package's Pallas kernels (interpret
    mode) on one churned tree a height: a two-piece and a three-piece
    plan."""
    cfg, t = _tree(height, 0, seed=7 * height, max_dnodes=256)
    roots, q = _lanes(cfg, t, 128, seed=3 * height)
    cap = cfg.walk_round_cap
    vp, cp = JVS.pad_arena(jnp.asarray(t.value.numpy()),
                           jnp.asarray(t.child.numpy()))
    want = JVS.veb_walk_fused(vp, cp, jnp.asarray(roots.numpy()),
                              jnp.asarray(q.numpy()), height=height,
                              q_tile=128, max_rounds=cap, interpret=True)
    got, _ = model_fused(t.value, t.child, roots, q, height=height,
                         max_rounds=cap)
    for name, a, b in zip(WALK, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    dn = np.asarray(roots.numpy())
    want = JVS.veb_walk_rows(vp[dn], cp[dn], jnp.asarray(q.numpy()),
                             height=height, q_tile=128, interpret=True)
    d = torch.as_tensor(dn).long()
    got, _ = model_rows(t.value[d], t.child[d], q, height=height)
    for name, a, b in zip(ROWS, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


@pytest.mark.parametrize("height", [4, 7, 12, 14, 16])
def test_round_trips_per_search(height):
    """On the main path every lane starts at the root, which its block has
    staged: a search of D ΔNodes makes (D - 1) x len(plan) round trips to
    device memory, where reading router by router took D x H plus one a
    child hop; rows take one round trip a piece reached.  On the tall path
    a piece costs one more (its root's position first) and no root is
    staged: 2 D x len(plan), still fewer than router by router."""
    cfg, t = _tree(height, 0, seed=height)
    k = 96
    roots = t.root.expand(k).contiguous()
    _, q = _lanes(cfg, t, k, seed=height)
    q[:3] = q[3]
    got, trips = model_fused(t.value, t.child, roots, q, height=height,
                             max_rounds=cfg.walk_round_cap)
    hops = got[3]
    plan = len(piece_plan(height))
    tall = height > VS.SMEM_HEIGHT
    staged = not tall
    per_dnode = 2 if tall else 1                # round trips a piece
    root = (per_dnode - 1) if staged else per_dnode
    assert trips == int((root + (hops - 1) * per_dnode).sum()) * plan
    router_trips = int(hops.sum()) * (height + 1)
    assert (1 if tall else 2) * trips < router_trips
    rows, crows = _rows_of(t.value, t.child, roots)
    _, per_lane = model_rows(rows, crows, q, height=height)
    per_piece = 2 if tall else 1
    assert max(per_lane) == plan * per_piece and min(per_lane) >= per_piece


@pytest.mark.parametrize("height", [7, 12, 14, 16])
@pytest.mark.parametrize("block", [32, 64, 128, 256])
def test_lane_model_every_block_size(block, height):
    """Each built block size gives the plain version's bits on a churned
    tree with per-lane roots (a block's lanes share its first lane's
    staged root, which may not be their own); the sizes differ only in
    the round trips the staging saves, none on the tall path (14,
    16), which stages no root."""
    assert block in block_sizes()
    cfg, t = _tree(height, 0, seed=5 * height)
    roots, q = _lanes(cfg, t, 600, seed=block)
    kw = dict(height=height, max_rounds=cfg.walk_round_cap)
    want = TREF.ref_delta_walk_fused(t.value, t.child, roots, q, **kw)
    got, trips = model_fused(t.value, t.child, roots, q, block=block, **kw)
    _equal(want, got, WALK, (height, block))
    _, base = model_fused(t.value, t.child, roots, q, **kw)
    stages = height <= VS.SMEM_HEIGHT
    assert (trips == base) == (not stages or block == VS.DEFAULT_BLOCK)


@pytest.mark.parametrize("payload_bits", [0, 12])
@pytest.mark.parametrize("height", [13, 14, 15, 16, 17])
def test_tall_root_read_in_place(height, payload_bits):
    """On the tall path the fused kernel stages no root: every block size
    gives the plain version's bits with the same round trips, two a piece
    in every ΔNode a lane visits, the root included."""
    cfg, t = _tree(height, payload_bits, seed=height + payload_bits,
                   max_dnodes=8 if height > 16 else None)
    k = 160
    roots = t.root.expand(k).contiguous()
    _, q = _lanes(cfg, t, k, seed=height)
    kw = dict(height=height, max_rounds=cfg.walk_round_cap)
    want = TREF.ref_delta_walk_fused(t.value, t.child, roots, q, **kw)
    trips = set()
    for block in (32, VS.DEFAULT_BLOCK):
        got, n = model_fused(t.value, t.child, roots, q, block=block, **kw)
        _equal(want, got, WALK, (height, payload_bits, block))
        trips.add(n)
    assert trips == {2 * len(piece_plan(height)) * int(want[3].sum())}