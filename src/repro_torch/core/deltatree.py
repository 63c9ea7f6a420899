"""ΔTree — locality-aware concurrent search tree (paper §3–4), in PyTorch.

Port of ``repro.core.deltatree``; the semantics map, the layout and the
occupancy invariants I1–I5 are documented there and hold here unchanged.
What differs is the execution model:

- JAX's traced control flow (``lax.while_loop`` / ``cond`` / ``switch`` /
  ``fori_loop``, ``vmap``) becomes eager PyTorch with Python control flow.
  The batched parts (SEARCHNODE resolution, the vectorized update fast
  path, the walk kernels) run as tensor ops on the tree's device; the
  per-op and per-ΔNode parts (single inserts/deletes, Rebalance / Expand /
  Merge) read the few rows they need to the host, decide there, and write
  the changed entries back.  On a card every such read is a host sync;
  eager maintenance pays them per op and per repair.
- The JAX ``update_batch`` donates its tree.  Here updates and maintenance
  modify the tree's tensors **in place**: the ``DeltaTree`` passed in is
  the one returned, and no earlier reference to it stays a snapshot.
- Out-of-range scatters, which JAX drops silently, are filtered by their
  masks before they are issued.

MAP MODE (``payload_bits > 0``): values are int64 ``key << bits | payload``
packs; queries pack an all-ones payload so that a query for key k compares
``>=`` any stored pack of k.  With ``payload_bits == 0`` everything is int32.

Entry points that make a tree (`empty`, `bulk_build`, `from_numpy`) place it
on ``cuda`` unless the caller passes ``device="cpu"``; with no card and no
explicit device they raise.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import layout
from repro_torch.core.layout import EMPTY, ROUTE_LEFT
from repro_torch.obs import trace as TR

NONE = -1
OP_SEARCH, OP_INSERT, OP_DELETE = 0, 1, 2


def _i32(x: int) -> int:
    """Wrap a Python int to int32, as an int64 -> int32 cast does."""
    return (x + 2**31) % 2**32 - 2**31


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; raises when no card is present
    and the caller did not ask for the CPU (never falls back quietly)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Static ΔTree parameters (field names and defaults as in
    ``repro.core.deltatree.TreeConfig``, which documents each).

    In this package ``engine`` names a `repro_torch.core.engine` engine,
    ``walk_fused`` picks the fused CUDA walk (True) or the per-round one
    (False), ``maintenance`` takes any policy of `maintenance.policy`,
    ``collect_stats`` makes every read return a trailing ``ReadStats``
    (``collect_transfers`` adds its measured ``TransferStats``), and
    ``q_tile`` is the walk kernels' block size (threads a block, one of
    ``kernels.veb_search.BLOCK_SIZES``; 0 resolves it by
    ``kernels.ops.default_q_tile``: ``REPRO_TORCH_QTILE``, the autotune
    table, 64).  The CUDA kernels take any batch size.
    """

    height: int = 7
    max_dnodes: int = 1024
    buf_cap: int = 32
    max_rounds: int = 64
    payload_bits: int = 0
    parallel_updates: bool = True
    engine: str = "scalar"
    maintenance: str = "eager"
    q_tile: int = 0
    collect_stats: bool = False
    collect_transfers: bool = False
    walk_fused: bool = True
    walk_rounds: int = 0

    @property
    def walk_round_cap(self) -> int:
        """The walk round cap: ``walk_rounds``, else derived from (height,
        max_dnodes) by `kernels.ops.walk_round_cap`."""
        if self.walk_rounds:
            return self.walk_rounds
        from repro_torch.kernels.ops import walk_round_cap

        return walk_round_cap(self.height, self.max_dnodes)

    @property
    def maintenance_policy(self):
        """Parsed ``MaintenancePolicy`` (raises ValueError on a bad spec)."""
        from repro_torch.maintenance.policy import parse_policy

        return parse_policy(self.maintenance)

    @property
    def ub(self) -> int:
        return 2**self.height - 1

    @property
    def leaf_cap(self) -> int:
        return 2 ** (self.height - 1)

    @property
    def bottom0(self) -> int:
        return 2 ** (self.height - 1)

    @property
    def half_cap(self) -> int:
        return self.leaf_cap // 2

    # ---- packing helpers (identity in set mode); each takes a tensor or
    # ---- a Python int and returns the same kind

    @property
    def vdtype(self) -> torch.dtype:
        return torch.int64 if self.payload_bits else torch.int32

    @property
    def npdtype(self):
        return np.int64 if self.payload_bits else np.int32

    @property
    def pmask(self) -> int:
        return (1 << self.payload_bits) - 1

    @property
    def route_left(self) -> int:
        return 1 << 62 if self.payload_bits else int(ROUTE_LEFT)

    def pack(self, key, payload):
        bits = self.payload_bits
        if isinstance(key, torch.Tensor):
            if not bits:
                return key.to(torch.int32)
            payload = torch.as_tensor(payload, device=key.device)
            return (key.to(torch.int64) << bits) | (
                payload.to(torch.int64) & self.pmask)
        if not bits:
            return _i32(int(key))
        return (int(key) << bits) | (int(payload) & self.pmask)

    def qpack(self, key):
        """Query packing: all-ones payload so q >= any stored pack of key."""
        bits = self.payload_bits
        if isinstance(key, torch.Tensor):
            if not bits:
                return key.to(torch.int32)
            return (key.to(torch.int64) << bits) | self.pmask
        if not bits:
            return _i32(int(key))
        return (int(key) << bits) | self.pmask

    def key_of(self, x):
        bits = self.payload_bits
        if not bits:
            return x
        if isinstance(x, torch.Tensor):
            return (x >> bits).to(torch.int32)
        return _i32(int(x) >> bits)

    def payload_of(self, x):
        if isinstance(x, torch.Tensor):
            if not self.payload_bits:
                return torch.zeros_like(x)
            return (x & self.pmask).to(torch.int32)
        if not self.payload_bits:
            return 0
        return _i32(int(x) & self.pmask)


class DeltaTree(NamedTuple):
    """Arena-of-ΔNodes state: the 16 fields of the JAX ``DeltaTree`` with
    the same dtypes, as tensors on one device."""

    value: torch.Tensor       # (M, UB) packed values, vEB storage order
    mark: torch.Tensor        # (M, UB) bool — logical deletion
    child: torch.Tensor       # (M, leaf_cap) int32 child id per bottom slot, -1 none
    buf: torch.Tensor         # (M, buf_cap) packed overflow buffer
    nlive: torch.Tensor       # (M,) int32 live (unmarked, non-marker) leaves
    bcount: torch.Tensor      # (M,) int32 occupied buffer entries
    nchild: torch.Tensor      # (M,) int32 number of child links
    parent: torch.Tensor      # (M,) int32 parent ΔNode id (-1 root)
    pslot: torch.Tensor       # (M,) int32 bottom slot index within parent
    alive: torch.Tensor       # (M,) bool allocated
    free_stack: torch.Tensor  # (M,) int32 freelist
    free_top: torch.Tensor    # () int32 number of free ids on the stack
    root: torch.Tensor        # () int32 root ΔNode id
    ins_flag: torch.Tensor    # (M,) bool needs insert-side maintenance
    del_flag: torch.Tensor    # (M,) bool merge candidate
    alloc_fail: torch.Tensor  # () bool arena exhausted at some point (sticky)


def shard_of(trees: DeltaTree, s: int) -> DeltaTree:
    """Row ``s`` of a stacked (S, ...) DeltaTree (a forest's arenas) as a
    DeltaTree of views: reads see the stacked tensors, and in-place writes
    — every update and maintenance path here writes in place — land in
    them, 0-d fields (``free_top``, ``root``, ``alloc_fail``) included."""
    return DeltaTree(*(x[s] for x in trees))


# --------------------------------------------------------------------------
# construction and the state carry-over to and from numpy
# --------------------------------------------------------------------------


def _field_dtypes(cfg: TreeConfig) -> dict:
    vdt = cfg.npdtype
    i32 = np.int32
    return dict(value=vdt, mark=np.bool_, child=i32, buf=vdt, nlive=i32,
                bcount=i32, nchild=i32, parent=i32, pslot=i32, alive=np.bool_,
                free_stack=i32, free_top=i32, root=i32, ins_flag=np.bool_,
                del_flag=np.bool_, alloc_fail=np.bool_)


def from_numpy(cfg: TreeConfig, arrays, device=None) -> DeltaTree:
    """A tree from a mapping of field name to numpy array — e.g. the JAX
    tree as ``{k: np.asarray(v) for k, v in jax_tree._asdict().items()}``.
    Dtypes are checked against ``cfg``; shapes (0-d fields included) are
    kept.  Lossless, and the inverse of `to_numpy`."""
    dev = resolve_device(device)
    want = _field_dtypes(cfg)
    missing = set(DeltaTree._fields) - set(arrays)
    if missing:
        raise ValueError(f"from_numpy: missing fields {sorted(missing)}")
    fields = {}
    for name in DeltaTree._fields:
        a = np.asarray(arrays[name])
        if a.dtype != want[name]:
            raise TypeError(f"from_numpy: {name} is {a.dtype}, "
                            f"expected {np.dtype(want[name])}")
        fields[name] = torch.from_numpy(np.array(a, copy=True)).to(dev)
    return DeltaTree(**fields)


def to_numpy(t: DeltaTree) -> dict:
    """Field name -> numpy array copy of every tree field (host-side)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in t._asdict().items()}


def _empty_np(cfg: TreeConfig) -> dict:
    m, ub, lc, bc = cfg.max_dnodes, cfg.ub, cfg.leaf_cap, cfg.buf_cap
    # free stack holds ids M-1 .. 1 (0 is the root, pre-allocated)
    free = np.zeros(m, dtype=np.int32)
    free[: m - 1] = np.arange(m - 1, 0, -1, dtype=np.int32)
    alive = np.zeros(m, dtype=bool)
    alive[0] = True
    return dict(
        value=np.full((m, ub), EMPTY, cfg.npdtype),
        mark=np.zeros((m, ub), bool),
        child=np.full((m, lc), -1, np.int32),
        buf=np.full((m, bc), EMPTY, cfg.npdtype),
        nlive=np.zeros(m, np.int32), bcount=np.zeros(m, np.int32),
        nchild=np.zeros(m, np.int32), parent=np.full(m, -1, np.int32),
        pslot=np.zeros(m, np.int32), alive=alive, free_stack=free,
        free_top=np.int32(m - 1), root=np.int32(0),
        ins_flag=np.zeros(m, bool), del_flag=np.zeros(m, bool),
        alloc_fail=np.bool_(False),
    )


def empty(cfg: TreeConfig, device=None) -> DeltaTree:
    return from_numpy(cfg, _empty_np(cfg), device)


def bulk_build(cfg: TreeConfig, values, payloads=None,
               device=None) -> DeltaTree:
    """Build a half-dense ΔTree from unique keys (any order) with numpy on
    the host, then move it to ``device``."""
    dev = resolve_device(device)
    values = np.asarray(values, dtype=np.int64)
    order = np.argsort(values)
    values = values[order]
    if not (np.diff(values) > 0).all():
        raise ValueError("bulk_build: keys must be unique")
    if payloads is None:
        payloads = np.zeros(len(values), np.int64)
    else:
        payloads = np.asarray(payloads, np.int64)[order]
    if values.size and not (values[0] >= layout.KEY_MIN
                            and values[-1] <= layout.KEY_MAX):
        raise ValueError(f"bulk_build: keys must lie in "
                         f"[{layout.KEY_MIN}, {layout.KEY_MAX}]")
    npdt = cfg.npdtype
    if cfg.payload_bits:
        packed = (values << cfg.payload_bits) | (payloads & cfg.pmask)
    else:
        packed = values.astype(np.int32)
    route_left = npdt(cfg.route_left)

    arrays = _empty_np(cfg)
    m, g = cfg.max_dnodes, max(cfg.half_cap, 1)
    value, child = arrays["value"], arrays["child"]
    nlive, nchild = arrays["nlive"], arrays["nchild"]
    parent, pslot, alive = arrays["parent"], arrays["pslot"], arrays["alive"]
    alive[:] = False
    next_id = 0

    def new_node():
        nonlocal next_id
        i = next_id
        next_id += 1
        if i >= m:
            raise ValueError(f"bulk_build: arena too small (need > {m} ΔNodes)")
        alive[i] = True
        return i

    def rebuild_np(run, force_bottom=False):
        return layout.rebuild_values_np(
            cfg.height, run, run.size, force_bottom=force_bottom,
            dtype=npdt, route_left=route_left)

    if packed.size == 0:
        ids = [new_node()]
    else:
        ids, mins = [], []
        for s in range(0, packed.size, g):
            run = packed[s: s + g]
            i = new_node()
            value[i] = rebuild_np(run)
            nlive[i] = run.size
            ids.append(i)
            mins.append(run[0])
        while len(ids) > 1:
            nids, nmins = [], []
            for s in range(0, len(ids), g):
                kids = ids[s: s + g]
                kmins = np.asarray(mins[s: s + g], npdt)
                i = new_node()
                value[i] = rebuild_np(kmins, force_bottom=True)
                for slot, cid in enumerate(kids):
                    child[i, slot] = cid
                    parent[cid] = i
                    pslot[cid] = slot
                nchild[i] = len(kids)
                nids.append(i)
                nmins.append(kmins[0])
            ids, mins = nids, nmins

    free = np.zeros(m, np.int32)
    nfree = m - next_id
    free[:nfree] = np.arange(m - 1, next_id - 1, -1, dtype=np.int32)
    arrays.update(free_stack=free, free_top=np.int32(nfree),
                  root=np.int32(ids[0]))
    return from_numpy(cfg, arrays, dev)


def _pos(cfg: TreeConfig, device) -> torch.Tensor:
    """vEB position table as int64 indices on ``device``."""
    from repro_torch.kernels.ref import pos_table  # the kernels import core

    return pos_table(cfg.height, device).long()


def _pos_list(cfg: TreeConfig) -> list:
    return layout.veb_pos_table(cfg.height).tolist()


# --------------------------------------------------------------------------
# descend — the memory-transfer path (paper Fig. 8 / Lemma 2.1), host-driven
# --------------------------------------------------------------------------


def _descend(cfg: TreeConfig, t: DeltaTree, q: int, dn0: int, b0: int):
    """Walk from (dn0, b0) to the leaf position that owns packed query
    ``q`` (a Python int).  Reads one ΔNode row per ΔNode visited.

    Returns (dn, b, hops): ``hops`` counts ΔNodes visited (boundary
    crossings + 1) — the transfer statistic the engines report.
    """
    pos = _pos_list(cfg)
    bottom0 = cfg.bottom0
    dn, b, hops = int(dn0), int(b0), 1
    row = t.value[dn].tolist()
    while True:
        if b < bottom0:
            if row[pos[min(2 * b, 2 * bottom0 - 1)]] != EMPTY:   # internal
                b = 2 * b + int(q >= row[pos[b]])
                continue
            return dn, b, hops
        ch = int(t.child[dn, b - bottom0])
        if ch < 0:
            return dn, b, hops
        dn, b, hops = ch, 1, hops + 1
        row = t.value[dn].tolist()


# --------------------------------------------------------------------------
# Search — wait-free (paper Fig. 8, Lemma 4.1/4.2)
# --------------------------------------------------------------------------


def searchnode(cfg: TreeConfig, t: DeltaTree, keys, leaf_val, leaf_b, dn):
    """Paper SEARCHNODE resolution (Fig. 8 lines 9..17) at each walk's
    final position: leaf match & ~mark, else overflow-buffer membership;
    payload from the matching leaf or buffer slot.

    Batched over (K,) tensors, and the one resolution both engines use, so
    their bit-for-bit parity cannot drift.  Returns (found, payload | -1).
    """
    dev = t.value.device
    pos = _pos(cfg, dev)
    keys = torch.as_tensor(keys, dtype=torch.int32, device=dev)
    dn = dn.long()
    leaf_hit = (leaf_val != EMPTY) & (cfg.key_of(leaf_val) == keys)
    leaf_found = leaf_hit & ~t.mark[dn, pos[leaf_b.long()]]
    brow = t.buf[dn]                              # (K, buf_cap)
    bhit = (brow != EMPTY) & (cfg.key_of(brow) == keys[:, None])
    in_buf = bhit.any(dim=1)
    first = bhit.to(torch.int32).argmax(dim=1, keepdim=True)
    bsel = torch.gather(brow, 1, first)[:, 0]
    found = torch.where(leaf_hit, leaf_found, in_buf)
    payload = torch.where(leaf_hit, cfg.payload_of(leaf_val),
                          cfg.payload_of(bsel))
    return found, torch.where(found, payload, -1).to(torch.int32)


def search_one(cfg: TreeConfig, t: DeltaTree, key: int):
    """Returns (found: bool, payload: int, hops: int)."""
    dn, b, hops = _descend(cfg, t, cfg.qpack(key), int(t.root), 1)
    dev = t.value.device
    pos = _pos_list(cfg)
    found, payload = searchnode(
        cfg, t, torch.tensor([key], dtype=torch.int32, device=dev),
        t.value[dn, pos[b]].reshape(1),
        torch.tensor([b], dtype=torch.int32, device=dev),
        torch.tensor([dn], dtype=torch.int32, device=dev))
    return bool(found[0]), int(payload[0]), hops


def search_batch(cfg: TreeConfig, t: DeltaTree, keys):
    """Wait-free search via ``cfg.engine``: (found[K], hops[K]), plus a
    trailing ``ReadStats`` when ``cfg.collect_stats``."""
    from repro_torch.core import engine as E  # deferred: engine imports us

    return E.search(cfg, t, keys)


def lookup_batch(cfg: TreeConfig, t: DeltaTree, keys):
    """Map-mode search via ``cfg.engine``: (found[K], payload[K], hops[K]),
    plus a trailing ``ReadStats`` when ``cfg.collect_stats``."""
    from repro_torch.core import engine as E  # deferred: engine imports us

    return E.lookup(cfg, t, keys)


def successor_batch(cfg: TreeConfig, t: DeltaTree, keys):
    """Wait-free successor queries via ``cfg.engine``: (found[K], succ[K])."""
    from repro_torch.core import engine as E  # deferred: engine imports us

    return E.successor(cfg, t, keys)


# JAX's jitted entry points, by name and signature: nothing is compiled here,
# so each calls its batch function.


def search_jit(cfg: TreeConfig, t: DeltaTree, keys):
    return search_batch(cfg, t, keys)


def lookup_jit(cfg: TreeConfig, t: DeltaTree, keys):
    return lookup_batch(cfg, t, keys)


def successor_jit(cfg: TreeConfig, t: DeltaTree, keys):
    return successor_batch(cfg, t, keys)


# --------------------------------------------------------------------------
# allocation helpers
# --------------------------------------------------------------------------


def _alloc(cfg: TreeConfig, t: DeltaTree):
    """Pop a ΔNode id off the freelist.  Returns (t, cid).  Sticky-fails
    when exhausted (the id under the stack bottom is returned, alloc_fail
    is set)."""
    ft = int(t.free_top)
    top = max(ft - 1, 0)
    cid = int(t.free_stack[top])
    if ft > 0:
        t.free_top.fill_(top)
    else:
        t.alloc_fail.fill_(True)
    t.alive[cid] = True
    return t, cid


def _free(cfg: TreeConfig, t: DeltaTree, dn: int) -> DeltaTree:
    t.value[dn] = EMPTY
    t.mark[dn] = False
    t.child[dn] = -1
    t.buf[dn] = EMPTY
    for f in (t.nlive, t.bcount, t.nchild, t.pslot):
        f[dn] = 0
    t.parent[dn] = -1
    t.alive[dn] = False
    t.ins_flag[dn] = False
    t.del_flag[dn] = False
    ft = int(t.free_top)
    if ft < cfg.max_dnodes:   # a full stack drops the push, as JAX does
        t.free_stack[ft] = dn
    t.free_top.fill_(ft + 1)
    return t


# --------------------------------------------------------------------------
# ΔNode rebuild (Rebalance core, paper Fig. 10 BALANCETREE)
# --------------------------------------------------------------------------


def _rebuild_row(cfg: TreeConfig, sorted_vals: np.ndarray, m: int,
                 force_bottom: bool = False) -> np.ndarray:
    """A (UB,) vEB-order value row holding the first ``m`` entries of
    ``sorted_vals`` (packed) as a complete leaf-oriented BST at minimal leaf
    depth (or pinned to the bottom row).  Host numpy."""
    return layout.rebuild_values_np(cfg.height, sorted_vals, m, force_bottom,
                                    cfg.npdtype, cfg.route_left)


def _set_row(t_field: torch.Tensor, dn: int, row: np.ndarray) -> None:
    t_field[dn] = torch.from_numpy(row).to(t_field.device)


def _gather_live(cfg: TreeConfig, t: DeltaTree, dn: int):
    """Sorted live packed values of ΔNode ``dn`` (own leaves + buffer;
    child-link markers excluded).  Returns (sorted (UB+buf_cap,) numpy
    array ascending with ROUTE_LEFT padding at the end, count)."""
    pos = layout.veb_pos_table(cfg.height)
    h, bottom0 = cfg.height, cfg.bottom0
    npdt = cfg.npdtype
    value = t.value[dn].cpu().numpy()
    mark = t.mark[dn].cpu().numpy()
    child = t.child[dn].cpu().numpy()
    buf = t.buf[dn].cpu().numpy()
    bfs = np.arange(1, 2**h)
    vals = value[pos[bfs]]
    marks = mark[pos[bfs]]
    at_bottom = bfs >= bottom0
    left = np.where(at_bottom, 0,
                    value[pos[np.minimum(2 * bfs, 2 * bottom0 - 1)]])
    is_leaf = at_bottom | (left == EMPTY)
    slot = np.where(at_bottom, bfs - bottom0, 0)
    is_marker = at_bottom & (child[slot] >= 0)
    live = is_leaf & (vals != EMPTY) & ~marks & ~is_marker
    rl = npdt(cfg.route_left)
    keep = np.where(live, vals, rl)
    bkeep = np.where(buf != EMPTY, buf, rl)
    allv = np.sort(np.concatenate([keep, bkeep]).astype(npdt))
    return allv, int(live.sum()) + int(t.bcount[dn])


@TR.traced("maint.rebalance")
def _rebalance(cfg: TreeConfig, t: DeltaTree, dn: int) -> DeltaTree:
    """Paper REBALANCE: rebuild ``dn``'s (childless) tree at minimal height
    from its live leaves + buffer (the mirror-swap, in place)."""
    allv, m = _gather_live(cfg, t, dn)
    _set_row(t.value, dn, _rebuild_row(cfg, allv, m))
    t.mark[dn] = False
    t.buf[dn] = EMPTY
    t.nlive[dn] = m
    t.bcount[dn] = 0
    t.ins_flag[dn] = False
    return t


# --------------------------------------------------------------------------
# single-op primitives (paper Fig. 9) — applied in batch order
# --------------------------------------------------------------------------


def _buf_append(cfg: TreeConfig, t: DeltaTree, dn: int, pv: int):
    """Append packed value to dn's buffer (paper Fig. 9 line 89).
    Returns (t, ok); a full buffer changes nothing."""
    row = t.buf[dn].tolist()
    if EMPTY not in row:
        return t, False
    t.buf[dn, row.index(EMPTY)] = pv
    t.bcount[dn] += 1
    t.ins_flag[dn] = True
    return t, True


def _grow_leaf(cfg: TreeConfig, t: DeltaTree, dn: int, b: int, pv: int):
    """Paper Fig. 9 lines 50..72: leaf x grows into internal(router=max)
    with leaves (min, max).  Preserves x's mark on x's new position."""
    pos = _pos_list(cfg)
    x = int(t.value[dn, pos[b]])
    xm = bool(t.mark[dn, pos[b]])
    v_lt = cfg.key_of(pv) < cfg.key_of(x)
    lo, hi = (pv, x) if v_lt else (x, pv)
    lpos, rpos = pos[2 * b], pos[2 * b + 1]
    t.value[dn, lpos] = lo
    t.value[dn, rpos] = hi
    t.value[dn, pos[b]] = hi
    t.mark[dn, lpos] = False if v_lt else xm
    t.mark[dn, rpos] = xm if v_lt else False
    t.mark[dn, pos[b]] = False
    t.nlive[dn] += 1
    return t


def _buf_find(cfg: TreeConfig, t: DeltaTree, dn: int, key: int) -> int:
    """Slot of ``key`` in ``dn``'s buffer, -1 when absent."""
    for j, x in enumerate(t.buf[dn].tolist()):
        if x != EMPTY and cfg.key_of(x) == key:
            return j
    return -1


def _write_leaf(t: DeltaTree, dn: int, p: int, pv: int, live_delta: int):
    """Store ``pv`` unmarked at storage position ``p`` of ``dn`` and add
    ``live_delta`` to its live count (a placement, or a duplicate revived
    or kept)."""
    t.value[dn, p] = pv
    t.mark[dn, p] = False
    t.nlive[dn] += live_delta


def _insert_op(cfg: TreeConfig, t: DeltaTree, key: int, payload: int,
               dn0=None, b0=None):
    """One INSERTNODE in batch order.  Returns (t, success, pending).

    ``(dn0, b0)`` is an optional descent hint — a position known to be on
    the key's root descent path (the lockstep update path passes the
    round-start frontier position; within an op phase structure only grows
    downward, so descending from the hint reaches the true endpoint)."""
    pos = _pos_list(cfg)
    pv = cfg.pack(key, payload)
    if dn0 is None:
        dn0, b0 = int(t.root), 1
    dn, b, _ = _descend(cfg, t, cfg.qpack(key), dn0, b0)
    leaf_val = int(t.value[dn, pos[b]])
    leaf_mark = bool(t.mark[dn, pos[b]])
    leaf_hit = leaf_val != EMPTY and cfg.key_of(leaf_val) == key
    if leaf_hit:      # leaf holds key: revive if deleted (payload refreshed)
        _write_leaf(t, dn, pos[b], pv if leaf_mark else leaf_val,
                    int(leaf_mark))
        return t, leaf_mark, False
    # a key resident in this ΔNode's buffer is a duplicate whatever leaf
    # kind the descent ended on
    if _buf_find(cfg, t, dn, key) >= 0:
        return t, False, False
    if leaf_val == EMPTY:          # unoccupied leaf position (incl. empty root)
        _write_leaf(t, dn, pos[b], pv, 1)
        return t, True, False
    if b < cfg.bottom0:
        return _grow_leaf(cfg, t, dn, b, pv), True, False
    # full bottom leaf: buffer it; a full buffer leaves the op pending,
    # retried after maintenance
    t, ok = _buf_append(cfg, t, dn, pv)
    return t, ok, not ok


def _delete_op(cfg: TreeConfig, t: DeltaTree, key: int, dn0=None, b0=None):
    """One DELETENODE in batch order (mark-delete, paper Fig. 9 l.18).
    ``(dn0, b0)`` is an optional descent hint, as in `_insert_op`."""
    pos = _pos_list(cfg)
    if dn0 is None:
        dn0, b0 = int(t.root), 1
    dn, b, _ = _descend(cfg, t, cfg.qpack(key), dn0, b0)
    leaf_val = int(t.value[dn, pos[b]])
    leaf_mark = bool(t.mark[dn, pos[b]])
    if leaf_val != EMPTY and cfg.key_of(leaf_val) == key:
        ok = not leaf_mark
        nl = int(t.nlive[dn]) - int(ok)
        t.mark[dn, pos[b]] = True
        t.nlive[dn] = nl
        if ok and nl < cfg.half_cap // 2:
            t.del_flag[dn] = True
        return t, ok, False
    j = _buf_find(cfg, t, dn, key)
    if j < 0:
        return t, False, False
    t.buf[dn, j] = EMPTY
    t.bcount[dn] -= 1
    return t, True, False


# --------------------------------------------------------------------------
# maintenance — Rebalance / Expand (paper Fig. 9 lines 92..106)
# --------------------------------------------------------------------------


def _process_ins(cfg: TreeConfig, t: DeltaTree, dn: int):
    """Insert-side repair of ΔNode ``dn`` (Rebalance or Expand).  Returns
    (t, rebuilds, expands) — the deltas that feed ``MaintenanceStats``
    (expands counts child ΔNodes allocated)."""
    dn = int(dn)
    total = int(t.nlive[dn]) + int(t.bcount[dn])
    if int(t.nchild[dn]) == 0 and total <= cfg.half_cap:
        return _rebalance(cfg, t, dn), 1, 0
    return _expand(cfg, t, dn)


@TR.traced("maint.expand")
def _expand(cfg: TreeConfig, t: DeltaTree, dn: int):
    """Paper EXPAND: route every buffered value of ``dn`` one hop toward
    its home — place or grow in this ΔNode, move into a child's buffer, or
    expand a full bottom leaf into a fresh child ΔNode (paper Fig. 5b) and
    move into it.  Returns (t, 0, child ΔNodes allocated)."""
    pos = _pos_list(cfg)
    ft0 = int(t.free_top)
    for i in range(cfg.buf_cap):
        pv = int(t.buf[dn, i])
        if pv == EMPTY:
            continue
        key = cfg.key_of(pv)
        # drop from this buffer first; re-add below if it must stay
        t.buf[dn, i] = EMPTY
        t.bcount[dn] -= 1
        tdn, b, _ = _descend(cfg, t, cfg.qpack(key), dn, 1)
        leaf_val = int(t.value[tdn, pos[b]])
        leaf_mark = bool(t.mark[tdn, pos[b]])
        if tdn != dn:             # landed in a descendant ΔNode: its buffer
            t, ok = _buf_append(cfg, t, tdn, pv)
            if not ok:            # full: keep it here
                t, _ = _buf_append(cfg, t, dn, pv)
        elif leaf_val != EMPTY and cfg.key_of(leaf_val) == key:    # dup
            _write_leaf(t, tdn, pos[b], pv if leaf_mark else leaf_val,
                        int(leaf_mark))
        elif leaf_val == EMPTY:                                    # place
            _write_leaf(t, tdn, pos[b], pv, 1)
        elif b < cfg.bottom0:                                      # grow
            t = _grow_leaf(cfg, t, tdn, b, pv)
        else:
            # occupied childless bottom leaf: allocate a child seeded with
            # the leaf's live value; pv moves into the child's (empty)
            # buffer and the leaf stays as the link's marker
            slot = b - cfg.bottom0
            t, cid = _alloc(cfg, t)
            mseed = int(not leaf_mark)
            seed = leaf_val if mseed else cfg.route_left
            _set_row(t.value, cid,
                     _rebuild_row(cfg, np.asarray([seed]), mseed))
            t.nlive[cid] = mseed
            t.nlive[tdn] -= mseed
            t.parent[cid] = tdn
            t.pslot[cid] = slot
            t.child[tdn, slot] = cid
            t.nchild[tdn] += 1
            t.mark[tdn, pos[b]] = False
            t, _ = _buf_append(cfg, t, cid, pv)
    t.ins_flag[dn] = int(t.bcount[dn]) > 0
    return t, 0, ft0 - int(t.free_top)


# --------------------------------------------------------------------------
# maintenance — Merge (paper Fig. 10 MERGETREE)
# --------------------------------------------------------------------------


@TR.traced("maint.merge")
def _process_del(cfg: TreeConfig, t: DeltaTree, dn: int):
    """Delete-side repair of ΔNode ``dn`` (Merge).  Returns (t, merged) —
    the delta that feeds ``MaintenanceStats``."""
    dn = int(dn)
    pos = _pos_list(cfg)
    t.del_flag[dn] = False
    p = int(t.parent[dn])
    eligible = (bool(t.alive[dn]) and p >= 0 and int(t.nchild[dn]) == 0
                and int(t.bcount[dn]) == 0
                and int(t.nlive[dn]) < cfg.half_cap)
    if not eligible:
        return t, 0
    s = int(t.pslot[dn])
    sib, even = s ^ 1, s & ~1
    b_dn = cfg.bottom0 + s        # dn's slot, BFS in parent
    b_sib = cfg.bottom0 + sib
    b_par = b_dn // 2             # the depth H-2 router node
    sib_child = int(t.child[p, sib])
    sib_leaf_val = int(t.value[p, pos[b_sib]])
    sib_leaf_mark = bool(t.mark[p, pos[b_sib]])
    sib_is_child = sib_child >= 0
    sib_ok = (not sib_is_child
              or (int(t.nchild[sib_child]) == 0
                  and int(t.bcount[sib_child]) == 0))
    my_vals, my_m = _gather_live(cfg, t, dn)
    if sib_is_child:
        sib_vals, sib_m = _gather_live(cfg, t, sib_child)
    else:
        sib_live = sib_leaf_val != EMPTY and not sib_leaf_mark
        sib_vals = np.full_like(my_vals, cfg.route_left)
        if sib_live:
            sib_vals[0] = sib_leaf_val
        sib_m = int(sib_live)
    total = my_m + sib_m
    if not (sib_ok and total <= cfg.half_cap):
        return t, 0

    union = np.sort(np.concatenate([my_vals, sib_vals]))
    _set_row(t.value, dn, _rebuild_row(cfg, union, total))
    t.mark[dn] = False
    t.nlive[dn] = total
    if sib_is_child:
        t = _free(cfg, t, sib_child)
    # dn becomes the merged ΔNode, re-hung at the even slot; the odd slot
    # is cleared and the router re-set to ROUTE_LEFT — the implicit-layout
    # version of the paper's pointer splice
    b_even = cfg.bottom0 + even
    b_odd = b_even + 1
    marker = int(union[0]) if total > 0 else 1
    t.child[p, even] = dn
    t.child[p, even ^ 1] = -1
    if sib_is_child:
        t.nchild[p] -= 1
    t.pslot[dn] = even
    t.value[p, pos[b_even]] = marker
    t.value[p, pos[b_odd]] = EMPTY
    t.value[p, pos[b_par]] = cfg.route_left
    t.mark[p, pos[b_even]] = False
    t.mark[p, pos[b_odd]] = False
    if not sib_is_child:      # a live sibling leaf value was absorbed
        t.nlive[p] -= sib_m
    return t, 1


# --------------------------------------------------------------------------
# batched update step
# --------------------------------------------------------------------------


def _later_duplicate(ids: torch.Tensor) -> torch.Tensor:
    """True where an earlier row (in batch order) holds the same id."""
    sid, order = torch.sort(ids, stable=True)
    dup_sorted = torch.cat([torch.zeros(1, dtype=torch.bool, device=ids.device),
                            sid[1:] == sid[:-1]])
    out = torch.zeros_like(dup_sorted)
    out[order] = dup_sorted
    return out


def _parallel_fastpath(cfg: TreeConfig, t: DeltaTree, kinds, keys, payloads,
                       results, pending, dns, bs):
    """Vectorized first pass: apply all *non-conflicting* updates with
    batched scatters — the SPMD realization of the paper's non-blocking
    concurrency (conflicting ops lose the CAS and retry via the sequential
    path).  ``(dns, bs)`` are the batch's frontier leaf positions.

    Handled vectorized: delete-mark, delete-miss, insert-place,
    insert-grow, insert-revive, insert-dup (leaf or buffer).  Left pending:
    bottom-leaf buffered inserts, ops on keys resident in the final ΔNode's
    overflow buffer, and any op conflicting on key or leaf position with an
    earlier row (the earliest-in-batch op wins).  Scatters are issued for
    the masked rows only, so no index is ever out of range.
    """
    pos = _pos(cfg, t.value.device)
    pv = cfg.pack(keys, payloads)
    key_loser = _later_duplicate(keys)
    slot_loser = _later_duplicate(dns * (2 ** cfg.height) + bs)
    elig = pending & ~key_loser & ~slot_loser

    dnl = dns.long()
    vpos = pos[bs.long()]
    leaf_val = t.value[dnl, vpos]
    leaf_mark = t.mark[dnl, vpos]
    leaf_hit = (leaf_val != EMPTY) & (cfg.key_of(leaf_val) == keys)
    at_bottom = bs >= cfg.bottom0
    is_ins = kinds == OP_INSERT
    is_del = kinds == OP_DELETE
    # final-ΔNode buffer probe: a buffered key may surface at ANY leaf kind
    brow = t.buf[dnl]
    in_buf = ((brow != EMPTY) & (cfg.key_of(brow) == keys[:, None])).any(1)

    del_ok = elig & is_del & leaf_hit & ~leaf_mark
    # a buffered hit needs the sequential path (dynamic-slot clear); a miss
    # at a BOTTOM leaf may still race mid-round inserts — defer those too
    del_miss = elig & is_del & (leaf_hit & leaf_mark
                                | (~leaf_hit & ~at_bottom & ~in_buf))
    ins_dup = elig & is_ins & leaf_hit & ~leaf_mark
    ins_bufdup = elig & is_ins & ~leaf_hit & in_buf
    ins_revive = elig & is_ins & leaf_hit & leaf_mark
    ins_place = elig & is_ins & (leaf_val == EMPTY) & ~in_buf
    ins_grow = (elig & is_ins & ~leaf_hit & ~in_buf
                & (leaf_val != EMPTY) & ~at_bottom)

    t.mark[dnl[del_ok], vpos[del_ok]] = True
    w = ins_revive | ins_place
    t.value[dnl[w], vpos[w]] = pv[w]
    t.mark[dnl[w], vpos[w]] = False
    # grow: leaf x -> internal(router=hi) + leaves (lo, hi); x's mark moves
    v_lt = cfg.key_of(pv) < cfg.key_of(leaf_val)
    lo = torch.where(v_lt, pv, leaf_val)
    hi = torch.where(v_lt, leaf_val, pv)
    bsafe = bs.long().clamp(max=cfg.bottom0 - 1)
    lpos, rpos = pos[2 * bsafe], pos[2 * bsafe + 1]
    g = ins_grow
    gdn = dnl[g]
    t.value[gdn, lpos[g]] = lo[g]
    t.value[gdn, rpos[g]] = hi[g]
    t.value[gdn, vpos[g]] = hi[g]
    t.mark[gdn, lpos[g]] = (~v_lt & leaf_mark)[g]
    t.mark[gdn, rpos[g]] = (v_lt & leaf_mark)[g]
    t.mark[gdn, vpos[g]] = False

    dlt = ((ins_revive | ins_place | ins_grow).to(torch.int32)
           - del_ok.to(torch.int32))
    old_nlive = t.nlive.clone()
    t.nlive.index_add_(0, dnl[elig], dlt[elig])
    t.del_flag.logical_or_((t.nlive < cfg.half_cap // 2) & (t.nlive < old_nlive))

    done = (del_ok | del_miss | ins_dup | ins_bufdup | ins_revive
            | ins_place | ins_grow)
    ok = del_ok | ins_revive | ins_place | ins_grow
    results = torch.where(done, ok, results)
    pending = pending & ~done
    return t, results, pending


def update_batch_impl(cfg: TreeConfig, t: DeltaTree, kinds, keys,
                      payloads=None):
    """Apply a batch of update ops (insert/delete) in batch order, then run
    maintenance under ``cfg.maintenance`` (eager: to fixpoint, the paper
    semantics).  Returns (tree, results[K] bool, MaintenanceStats).

    The tree is updated **in place** (the returned tree is ``t``).
    Searches are not taken here — use `search_batch` before the update.
    """
    from repro_torch.maintenance import scheduler as MS  # deferred: imports us

    return MS.run_update(cfg, t, kinds, keys, payloads)


def flush_impl(cfg: TreeConfig, t: DeltaTree, budget: int = 64):
    """Drain all pending maintenance to fixpoint (restores invariant I5).
    Returns (tree, MaintenanceStats); in place, like `update_batch_impl`."""
    from repro_torch.maintenance import scheduler as MS  # deferred: imports us

    return MS.flush(cfg, t, budget)


update_batch = update_batch_impl
flush = flush_impl


def buffered_floor(cfg: TreeConfig, t: DeltaTree, keys):
    """Smallest *buffered* packed value strictly greater than each key
    (``cfg.route_left`` when none) — the successor contribution of pending
    overflow-buffer items on I5' trees.  One global sort of the buffer
    arena + a searchsorted per query, skipped when every buffer is empty."""
    dev = t.buf.device
    keys = torch.as_tensor(keys, dtype=torch.int32, device=dev)
    if not bool((t.bcount > 0).any()):
        return torch.full(keys.shape, cfg.route_left, dtype=cfg.vdtype,
                          device=dev)
    flat = torch.where(t.buf != EMPTY, t.buf, cfg.route_left).reshape(-1)
    s = torch.sort(flat).values
    # qpack packs an all-ones payload, so right=True lands on the first
    # entry whose *key* is strictly greater (map and set alike)
    idx = torch.searchsorted(s, cfg.qpack(keys), right=True)
    safe = idx.clamp(0, s.shape[0] - 1)
    return torch.where(idx < s.shape[0], s[safe],
                       torch.full_like(s[safe], cfg.route_left))


def buffered_member(cfg: TreeConfig, t: DeltaTree, keys):
    """True per key iff the key is pending in some ΔNode's overflow buffer
    (I5' trees); same shape as `buffered_floor`."""
    dev = t.buf.device
    keys = torch.as_tensor(keys, dtype=torch.int32, device=dev)
    if not bool((t.bcount > 0).any()):
        return torch.zeros(keys.shape, dtype=torch.bool, device=dev)
    in_domain = (keys >= layout.KEY_MIN) & (keys <= layout.KEY_MAX)
    flat = torch.where(t.buf != EMPTY, t.buf, cfg.route_left).reshape(-1)
    s = torch.sort(flat).values
    # pack with payload 0: the smallest packed value of this key, so
    # right=False lands on the key's first stored entry if any
    qlow = cfg.pack(keys, torch.zeros_like(keys))
    idx = torch.searchsorted(s, qlow.to(s.dtype), right=False)
    safe = idx.clamp(0, s.shape[0] - 1)
    hit = (idx < s.shape[0]) & (cfg.key_of(s[safe]) == keys)
    return hit & in_domain


# --------------------------------------------------------------------------
# debug / verification helpers (host-side)
# --------------------------------------------------------------------------


def _live_arrays(cfg: TreeConfig, t: DeltaTree):
    """(keys, payloads) int64 numpy arrays of every live item, sorted by
    (key, payload) — vectorized over the whole arena."""
    pos = layout.veb_pos_table(cfg.height)
    bottom0 = cfg.bottom0
    alive = t.alive.cpu().numpy()
    value = t.value.cpu().numpy()[alive]
    mark = t.mark.cpu().numpy()[alive]
    child = t.child.cpu().numpy()[alive]
    buf = t.buf.cpu().numpy()[alive]
    bfs = np.arange(1, 2**cfg.height)
    at_bottom = bfs >= bottom0
    vals = value[:, pos[bfs]]
    left = np.where(at_bottom[None, :], EMPTY,
                    value[:, pos[np.minimum(2 * bfs, 2 * bottom0 - 1)]])
    is_leaf = at_bottom[None, :] | (left == EMPTY)
    slot = np.where(at_bottom, bfs - bottom0, 0)
    marker = at_bottom[None, :] & (child[:, slot] >= 0)
    live = (is_leaf & (vals != EMPTY) & (vals != cfg.route_left)
            & ~marker & ~mark[:, pos[bfs]])
    items = np.concatenate([vals[live], buf[buf != EMPTY]]).astype(np.int64)
    bits = cfg.payload_bits
    if bits:
        keys, pays = items >> bits, items & cfg.pmask
    else:
        keys, pays = items, np.zeros_like(items)
    order = np.lexsort((pays, keys))
    return keys[order], pays[order]


def live_items(cfg: TreeConfig, t: DeltaTree):
    """All live (key, payload) pairs (host-side; for tests), key-sorted."""
    keys, pays = _live_arrays(cfg, t)
    return list(zip(keys.tolist(), pays.tolist()))


def live_keys(cfg: TreeConfig, t: DeltaTree) -> np.ndarray:
    return _live_arrays(cfg, t)[0]


# --------------------------------------------------------------------------
# ordered queries (beyond-paper: the ΔTree is an ordered dictionary)
# --------------------------------------------------------------------------


def successor_one(cfg: TreeConfig, t: DeltaTree, key: int,
                  max_chase: int = 8):
    """Smallest live key strictly greater than ``key`` (wait-free read).

    On every left turn the router is a lower bound on the right subtree's
    minimum, so the candidate is the smallest such router / final leaf >
    key.  A candidate may be stale (a mark-deleted leaf still acting as a
    router); then the walk chases `successor(candidate)`, at most
    ``max_chase`` times.  Returns (found: bool, succ_key: int or 0).
    """
    pos = _pos_list(cfg)
    bottom0 = cfg.bottom0
    big = cfg.route_left
    root = int(t.root)

    def one_pass(qkey):
        q = cfg.qpack(qkey)
        dn, b, cand = root, 1, big
        row = t.value[dn].tolist()
        while True:
            router = row[pos[b]]
            if b < bottom0 and row[pos[min(2 * b, 2 * bottom0 - 1)]] != EMPTY:
                if q < router and router < cand:   # left turn
                    cand = router
                b = 2 * b + int(q >= router)
                continue
            ch = int(t.child[dn, b - bottom0]) if b >= bottom0 else NONE
            if ch < 0:
                break
            dn, b = ch, 1
            row = t.value[dn].tolist()
        leaf_val = row[pos[b]]
        leaf_live = leaf_val != EMPTY and not bool(t.mark[dn, pos[b]])
        if leaf_live and cfg.key_of(leaf_val) > qkey and leaf_val < cand:
            cand = leaf_val
        return cand

    qk, ck, found = int(key), 0, False
    for _ in range(max_chase):
        cand = one_pass(qk)
        ck = cfg.key_of(cand)
        if cand >= big:
            # no candidate: every further pass would repeat this one
            break
        # verify liveness: the candidate router may be a tombstone
        if search_one(cfg, t, ck)[0]:
            found = True
            break
        qk = ck
    return found, ck if found else 0


def scan_one(cfg: TreeConfig, t: DeltaTree, start: int, hi: int,
             max_out: int, chase_slack: int = 16):
    """Scalar reference for the emit-cursor scan: up to ``max_out`` live
    *leaf* items with ``start < key <= hi`` in key order (a wait-free read;
    overflow buffers are merged by the engine dispatch, where I5'
    correctness lives).

    The pass structure mirrors the lockstep scan kernel
    (`kernels.ref.ref_delta_scan_fused`): a FIND pass (the `successor_one`
    candidate walk, leaf fold included) alternates with a VERIFY pass (an
    exact walk for the candidate key — candidate routers may be
    tombstones; dead candidates are chased without emitting), at most
    ``2 * (max_out + chase_slack)`` passes.  ``hops`` counts ΔNode visits
    across every pass, as the lockstep scan does.

    Returns (out (max_out,) packed ascending with ``cfg.route_left``
    padding, n int32, hops int32, more bool); ``more`` means the row filled
    with live items remaining — resume from ``key_of(out[n-1])``.
    """
    pos = _pos_list(cfg)
    bottom0 = cfg.bottom0
    big = cfg.route_left
    pm = cfg.pmask
    root = int(t.root)
    hi_q = cfg.qpack(int(hi))

    def walk_pass(q):
        # one root-to-leaf walk: (candidate fold, leaf value, leaf live,
        # ΔNodes visited)
        dn, b, cand, hops = root, 1, big, 1
        row = t.value[dn].tolist()
        while True:
            if b < bottom0 and row[pos[min(2 * b, 2 * bottom0 - 1)]] != EMPTY:
                router = row[pos[b]]
                if q < router < cand:              # left turn
                    cand = router
                b = 2 * b + int(q >= router)
                continue
            ch = int(t.child[dn, b - bottom0]) if b >= bottom0 else NONE
            if ch < 0:
                break
            dn, b, hops = ch, 1, hops + 1
            row = t.value[dn].tolist()
        leaf_val = row[pos[b]]
        leaf_live = leaf_val != EMPTY and not bool(t.mark[dn, pos[b]])
        return cand, leaf_val, leaf_live, hops

    cursor = cfg.qpack(int(start))
    out, n, hops, more = [big] * max_out, 0, 0, False
    for _ in range(2 * (max_out + chase_slack)):
        cand, lv, live, h1 = walk_pass(cursor)
        hops += h1
        if live and cursor < lv < cand:
            cand = lv
        if cand == big or cand > hi_q:
            break
        pending = cand | pm
        _, lv2, live2, h2 = walk_pass(pending)
        hops += h2
        if live2 and (lv2 | pm) == pending:
            if n == max_out:
                more = True
                break
            out[n] = lv2
            n += 1
        cursor = pending
    dev = t.value.device
    return (torch.tensor(out, dtype=cfg.vdtype, device=dev),
            torch.tensor(n, dtype=torch.int32, device=dev),
            torch.tensor(hops, dtype=torch.int32, device=dev),
            torch.tensor(more, device=dev))


def scan_batch(cfg: TreeConfig, t: DeltaTree, starts, his, max_out: int):
    """Ordered range scans via ``cfg.engine`` (buffered items merged under
    non-eager maintenance — see `engine.scan`)."""
    from repro_torch.core import engine as E  # deferred: engine imports us

    return E.scan(cfg, t, starts, his, max_out=max_out)


def successor_k_batch(cfg: TreeConfig, t: DeltaTree, keys, k: int):
    """Bulk ordered reads: the ``k`` smallest live keys strictly greater
    than each query key — a scan with an unbounded upper band."""
    from repro_torch.core import engine as E  # deferred: engine imports us

    return E.successor_k(cfg, t, keys, k)
