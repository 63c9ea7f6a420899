"""Baselines the paper compares the ΔTree against (§5), in PyTorch (port of
``repro.core.baselines``).

- PointerBST  — analog of the concurrent AVL/RB/speculation-friendly trees:
  explicit left/right child indices, nodes in allocation order (no
  locality).  Insert = leaf append (a randomly built tree has expected
  O(log n) height, the paper's Lemma 4.5 assumption); delete = logical mark.
- StaticVEB   — the paper's VTMtree: one complete BST in static vEB order,
  values at internal nodes.  Search-optimal, but any update rebuilds the
  whole layout (the paper's motivating weakness).
- SortedArray — binary search; batched updates rebuild by sort-merge.
- HashTable   — open-addressing linear probing (not in the paper; an extra
  locality reference point, labelled as such by the benchmarks).

Every structure exposes:
  build(values, ..., device=None) -> state   (host code; state on device)
  search(state, keys) -> found[K]             (batched tensor ops)
  update(state, kinds, keys) -> (state, results[K])
  touch_fn(state) -> key -> [flat indices]    (host; ideal-cache traces)

States are ``NamedTuple``s of tensors with the JAX field names; ``build``
returns exactly the JAX arrays.  ``PointerBSTState.depth`` and
``HashState.probe`` are host ints the JAX states do not have: bounds on a
search's loop (nodes on the longest root path; longest probe sequence), so
a search runs a fixed number of masked steps with no host sync.

`count_block_transfers` turns touch traces into the mean number of distinct
size-B blocks a search moves (the ideal-cache model the paper analyses; B in
elements).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import layout
from repro_torch.core.deltatree import resolve_device
from repro_torch.core.layout import EMPTY
from repro_torch.kernels.ref import pos_table

OP_SEARCH, OP_INSERT, OP_DELETE = 0, 1, 2
INT32_MAX = int(np.iinfo(np.int32).max)


def count_block_transfers(touch_fn, keys, block_elems: int) -> float:
    """Mean number of distinct B-element blocks touched per search."""
    total = 0
    for k in keys:
        idxs = touch_fn(int(k))
        total += len({i // block_elems for i in idxs})
    return total / max(len(keys), 1)


def _keys(keys, device) -> torch.Tensor:
    return torch.as_tensor(keys, dtype=torch.int32, device=device)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


# --------------------------------------------------------------------------
# Sorted array
# --------------------------------------------------------------------------


class SortedArrayState(NamedTuple):
    vals: torch.Tensor  # (cap,) int32 ascending, padded with INT32_MAX
    n: torch.Tensor     # () int32 (counts inserts past a full cap, as JAX)


class SortedArray:
    name = "sorted_array"

    @staticmethod
    def build(values, cap: int | None = None, device=None) -> SortedArrayState:
        dev = resolve_device(device)
        values = np.unique(np.asarray(values, np.int32))
        cap = cap or max(16, 2 * len(values))
        pad = np.full(cap, INT32_MAX, np.int32)
        pad[: len(values)] = values
        return SortedArrayState(torch.from_numpy(pad).to(dev),
                                torch.tensor(len(values), dtype=torch.int32,
                                             device=dev))

    @staticmethod
    def search(state: SortedArrayState, keys):
        keys = _keys(keys, state.vals.device)
        i = torch.searchsorted(state.vals, keys)
        i = i.clamp(0, state.vals.shape[0] - 1)
        return state.vals[i] == keys

    @staticmethod
    def update(state: SortedArrayState, kinds, keys):
        """Apply ``kinds``/``keys`` in batch order; results and state equal
        the JAX sequential loop.  The results come from one presence read
        and a host pass over the batch; the array is then rebuilt once by
        sort-merge.  Where an insert meets a full array (the JAX loop then
        drops the largest element, or overwrites it), the batch replays the
        JAX loop op by op on the device instead."""
        vals = state.vals
        dev, cap = vals.device, vals.shape[0]
        keys = _keys(keys, dev)
        kinds_h = _np(torch.as_tensor(kinds)).astype(np.int64)
        keys_h = _np(keys).astype(np.int64)
        present0 = _np(SortedArray.search(state, keys))
        real = int((vals != INT32_MAX).sum())
        n = int(state.n)
        now = {}                       # key -> present, for touched keys
        res = np.zeros(len(keys_h), bool)
        full = False
        for i, (k, v) in enumerate(zip(kinds_h, keys_h)):
            v = int(v)
            p = now.get(v, bool(present0[i]))
            if k == OP_INSERT:
                res[i] = not p
                if not p:
                    full |= real >= cap
                    real, n = real + 1, n + 1
                    now[v] = True
            else:
                res[i] = p
                if p:
                    real, n = real - 1, n - 1
                    now[v] = False
        if full:
            return SortedArray._replay(state, kinds, keys)
        first = dict(zip(keys_h.tolist(), present0.tolist()))
        gone = [v for v, p in now.items() if first[v] and not p]
        new = [v for v, p in now.items() if p and not first[v]]
        kept = vals[vals != INT32_MAX]
        if gone:
            kept = kept[~torch.isin(kept, _keys(gone, dev))]
        merged = torch.sort(torch.cat([kept, _keys(new, dev)])).values
        out = torch.full((cap,), INT32_MAX, dtype=torch.int32, device=dev)
        out[: merged.shape[0]] = merged
        return (SortedArrayState(out, torch.tensor(n, dtype=torch.int32,
                                                   device=dev)),
                torch.from_numpy(res).to(dev))

    @staticmethod
    def _replay(state: SortedArrayState, kinds, keys):
        """The JAX ``fori_loop`` body op by op (shift right on insert, left
        on delete, over the whole array), each branch a ``torch.where``.
        Returns (state, results)."""
        vals, n = state.vals.clone(), state.n.clone()
        dev, cap = vals.device, vals.shape[0]
        kinds = torch.as_tensor(kinds, device=dev)
        span = torch.arange(cap, device=dev)
        top = torch.tensor(INT32_MAX, dtype=torch.int32, device=dev)
        res = torch.zeros(keys.shape, dtype=torch.bool, device=dev)
        for i in range(keys.shape[0]):
            v = keys[i]
            idx = torch.searchsorted(vals, v.reshape(1))[0].clamp(0, cap - 1)
            present = vals[idx] == v
            is_ins = kinds[i] == OP_INSERT
            ins = torch.where(span > idx, torch.roll(vals, 1), vals)
            ins = torch.where(span == idx, v, ins)
            dele = torch.where(span >= idx, torch.roll(vals, -1), vals)
            dele = torch.where(span == cap - 1, top, dele)
            do_ins = is_ins & ~present
            do_del = ~is_ins & present
            res[i] = do_ins | do_del
            vals = torch.where(do_ins, ins, torch.where(do_del, dele, vals))
            n = n + do_ins.to(torch.int32) - do_del.to(torch.int32)
        return SortedArrayState(vals, n), res

    @staticmethod
    def touch_fn(state: SortedArrayState):
        vals = _np(state.vals)
        n = int(state.n)

        def touched(key: int) -> list[int]:
            lo, hi, out = 0, n, []
            while lo < hi:
                mid = (lo + hi) // 2
                out.append(mid)
                if vals[mid] < key:
                    lo = mid + 1
                elif vals[mid] > key:
                    hi = mid
                else:
                    break
            return out

        return touched


# --------------------------------------------------------------------------
# Static vEB monolith (VTMtree analog)
# --------------------------------------------------------------------------


class StaticVEBState(NamedTuple):
    store: torch.Tensor  # (2**h - 1,) int32 in vEB order, node-oriented BST
    height: int          # static


class StaticVEB:
    name = "static_veb"

    @staticmethod
    def _bst_values(values: np.ndarray, h: int) -> np.ndarray:
        """Sorted values placed into a complete node-oriented BST (BFS
        index), in-order = sorted; empty slots EMPTY.  The JAX recursion's
        split rule, evaluated one BFS level at a time: a subtree of
        ``size`` values puts ``(size - 1) // 2`` of them left when its
        complete left subtree holds that many, else as many as it holds."""
        out = np.full(2**h, EMPTY, np.int32)
        b = np.ones(1, np.int64)
        lo = np.zeros(1, np.int64)
        hi = np.full(1, len(values), np.int64)
        for depth in range(h):
            keep = lo < hi
            b, lo, hi = b[keep], lo[keep], hi[keep]
            if not b.size:
                break
            depth_left = h - (depth + 1)       # height below these nodes
            cap_left = 2**depth_left - 1 if depth_left > 0 else 0
            half = (hi - lo - 1) // 2
            root = lo + np.where(cap_left >= half, half, cap_left)
            out[b] = values[root]
            b = np.concatenate([2 * b, 2 * b + 1])
            lo, hi = np.concatenate([lo, root + 1]), np.concatenate([root, hi])
        return out

    @staticmethod
    def build(values, height: int | None = None,
              device=None) -> StaticVEBState:
        dev = resolve_device(device)
        values = np.unique(np.asarray(values, np.int32))
        h = height or max(1, int(np.ceil(np.log2(len(values) + 2))))
        while 2**h - 1 < len(values):
            h += 1
        bfs_vals = StaticVEB._bst_values(values, h)
        store = np.full(2**h - 1, EMPTY, np.int32)
        store[layout.veb_pos_table(h)[1:]] = bfs_vals[1:]
        return StaticVEBState(torch.from_numpy(store).to(dev), h)

    @staticmethod
    def search(state: StaticVEBState, keys):
        """``height`` masked steps down the vEB-ordered BST, all lanes at
        once: a lane stops at its key, at an EMPTY slot or below the last
        level."""
        store, h = state.store, state.height
        dev = store.device
        keys = _keys(keys, dev)
        pos = pos_table(h, dev).long()
        b = torch.ones_like(keys, dtype=torch.int64)
        found = torch.zeros(keys.shape, dtype=torch.bool, device=dev)
        active = torch.ones_like(found)
        for _ in range(h):
            x = store[pos[b]]
            hit = x == keys
            nb = 2 * b + (keys > x).long()
            found |= active & hit
            active &= ~hit & (x != EMPTY) & (nb < 2**h)
            b = torch.where(active, nb, b)
        return found

    @staticmethod
    def update(state: StaticVEBState, kinds, keys):
        """The paper's point: a static vEB layout cannot update in place —
        the whole layout is rebuilt on the host, blocking everything."""
        dev = state.store.device
        s = set(StaticVEB.to_sorted(state).tolist())
        kinds = _np(torch.as_tensor(kinds))
        keys = _np(torch.as_tensor(keys))
        res = np.zeros(len(keys), bool)
        for i, (k, v) in enumerate(zip(kinds, keys)):
            v = int(v)
            if k == OP_INSERT:
                res[i] = v not in s
                s.add(v)
            elif k == OP_DELETE:
                res[i] = v in s
                s.discard(v)
        return (StaticVEB.build(np.asarray(sorted(s), np.int32), None, dev),
                torch.from_numpy(res).to(dev))

    @staticmethod
    def to_sorted(state: StaticVEBState) -> np.ndarray:
        store = _np(state.store)
        return np.sort(store[store != EMPTY])

    @staticmethod
    def touch_fn(state: StaticVEBState):
        store = _np(state.store)
        h = state.height
        pos = layout.veb_pos_table(h)

        def touched(key: int) -> list[int]:
            b, out = 1, []
            while b < 2**h:
                p = int(pos[b])
                out.append(p)
                x = store[p]
                if x == key or x == EMPTY:
                    break
                b = 2 * b + (1 if key > x else 0)
            return out

        return touched


# --------------------------------------------------------------------------
# Pointer BST (concurrent AVL/RB/SF-tree analog: no locality)
# --------------------------------------------------------------------------


class PointerBSTState(NamedTuple):
    val: torch.Tensor    # (cap,) int32
    left: torch.Tensor   # (cap,) int32, -1 none
    right: torch.Tensor  # (cap,) int32
    mark: torch.Tensor   # (cap,) bool
    n: torch.Tensor      # () int32 nodes allocated
    root: torch.Tensor   # () int32
    depth: int           # host bound: nodes on the longest root path


class PointerBST:
    name = "pointer_bst"

    @staticmethod
    def build(values, cap: int | None = None, seed: int = 0,
              device=None) -> PointerBSTState:
        """The tree the JAX build makes by inserting ``values`` in the order
        ``default_rng(seed).permutation``, node ids in allocation order
        (memory layout uncorrelated with tree structure, like heap-allocated
        nodes of the Synchrobench trees).

        Inserting distinct keys in a given order makes the treap of the
        sorted keys whose priority is the insertion time, which is also the
        node id: one stack pass over the sorted keys builds it (every
        parent is inserted before its children) instead of a descent per
        insert."""
        dev = resolve_device(device)
        values = np.unique(np.asarray(values, np.int32))
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(values))
        cap = cap or max(16, 2 * len(values) + 16)
        n = len(values)
        val = np.zeros(cap, np.int32)
        left = np.full(cap, -1, np.int32)
        right = np.full(cap, -1, np.int32)
        val[:n] = values[order]
        nid = np.empty(n, np.int64)
        nid[order] = np.arange(n)             # node id of the i-th smallest
        lft, rgt = [-1] * n, [-1] * n
        stack: list[int] = []
        for i in nid.tolist():
            last = -1
            while stack and stack[-1] > i:
                last = stack.pop()
            lft[i] = last
            if stack:
                rgt[stack[-1]] = i
            stack.append(i)
        left[:n] = lft
        right[:n] = rgt
        return PointerBSTState(
            torch.from_numpy(val).to(dev), torch.from_numpy(left).to(dev),
            torch.from_numpy(right).to(dev),
            torch.zeros(cap, dtype=torch.bool, device=dev),
            torch.tensor(n, dtype=torch.int32, device=dev),
            torch.tensor(0 if n else -1, dtype=torch.int32, device=dev),
            PointerBST._depth(left, right, 0 if n else -1))

    @staticmethod
    def _depth(left: np.ndarray, right: np.ndarray, root: int) -> int:
        depth, level = 0, np.asarray([root], np.int64)
        while level.size and level[0] >= 0:
            depth += 1
            nxt = np.concatenate([left[level], right[level]])
            level = nxt[nxt >= 0]
        return depth

    @staticmethod
    def _descend(state: PointerBSTState, keys: torch.Tensor):
        """Batched descent to each key's node or attach point: ``depth``
        masked steps.  Returns (c, went_left, level): the last node
        visited, whether the key sorts below it, and nodes visited."""
        cap = state.val.shape[0]
        c = state.root.expand(keys.shape).clone()
        level = torch.zeros_like(keys)
        done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
        done |= state.root < 0
        for _ in range(state.depth):
            cc = c.clamp(0, cap - 1).long()
            x = state.val[cc]
            nl = torch.where(keys < x, state.left[cc], state.right[cc])
            level += (~done).to(torch.int32)
            stop = done | (x == keys) | (nl < 0)
            c = torch.where(stop, c, nl)
            done = stop
        x = state.val[c.clamp(0, cap - 1).long()]
        return c, keys < x, level

    @staticmethod
    def search(state: PointerBSTState, keys):
        keys = _keys(keys, state.val.device)
        cap = state.val.shape[0]
        c = state.root.expand(keys.shape).clone()
        found = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
        for _ in range(state.depth):
            active = c >= 0
            cc = c.clamp(0, cap - 1).long()
            x = state.val[cc]
            eq = active & (x == keys)
            found |= eq & ~state.mark[cc]
            nc = torch.where(keys < x, state.left[cc], state.right[cc])
            c = torch.where(eq | ~active, -1, nc)
        return found

    @staticmethod
    def update(state: PointerBSTState, kinds, keys):
        """Apply ``kinds``/``keys`` in batch order; results and state equal
        the JAX sequential loop (a revived mark, a delete of an absent key
        and a key inserted then deleted in one batch included).

        One batched descent finds each key's node or attach point in the
        pre-batch tree, which is where the JAX descent ends too unless an
        earlier op of the batch attached a node at that point: the host
        pass keeps those new nodes as small trees hanging off their attach
        points and continues such descents there.  The writes (new nodes,
        child links, marks, n) go back to the device once.  A batch that
        may allocate past ``cap`` nodes replays JAX's loop op by op
        instead (`_update_past_cap`)."""
        dev = state.val.device
        cap = state.val.shape[0]
        keys = _keys(keys, dev)
        kinds_h = _np(torch.as_tensor(kinds)).tolist()
        n, root, depth = int(state.n), int(state.root), state.depth
        if n + sum(k == OP_INSERT for k in kinds_h) > cap:
            return PointerBST._update_past_cap(state, kinds_h,
                                               _np(keys).tolist())
        c, went_left, level = PointerBST._descend(state, keys)
        cc = c.clamp(0, cap - 1).long()
        cols = torch.stack([c, went_left.to(torch.int32), level,
                            state.val[cc], state.mark[cc].to(torch.int32)])
        c_h, wl_h, lv_h, x_h, mk_h = _np(cols).tolist()
        keys_h = _np(keys).tolist()
        empty0 = root < 0
        mark = {}      # node -> its mark, where this batch changed it
        new = {}       # node attached in this batch -> [val, left, right]
        links = {}     # pre-batch attach point (node, is_left) -> new node
        res = np.zeros(len(keys_h), bool)
        for i, (k, v) in enumerate(zip(kinds_h, keys_h)):
            node, lev = c_h[i], lv_h[i]
            hit = not empty0 and x_h[i] == v
            parent, is_left = node, bool(wl_h[i])
            child = links.get((parent, is_left))
            while not hit and child is not None:
                node, lev = child, lev + 1
                nv, nl, nr = new[node]
                hit = nv == v
                parent, is_left = node, v < nv
                child = None if hit else (nl if v < nv else nr)
                child = None if child == -1 else child
            marked = mark.get(node, bool(mk_h[i]) if node == c_h[i]
                              else False)
            if k == OP_INSERT:
                ok = marked if hit else True
                if hit and ok:
                    mark[node] = False
                elif ok:
                    new[n] = [v, -1, -1]
                    if parent in new:
                        new[parent][1 if is_left else 2] = n
                    else:      # a pre-batch node, or the empty tree's root
                        links[(parent, is_left)] = n
                        if empty0:
                            root = n
                    depth = max(depth, lev + 1)
                    n += 1
            else:
                ok = hit and not marked
                if ok:
                    mark[node] = True
            res[i] = ok
        return (PointerBST._write(state, n, root, depth, mark, new, links),
                torch.from_numpy(res).to(dev))

    @staticmethod
    def _update_past_cap(state: PointerBSTState, kinds_h: list,
                         keys_h: list):
        """JAX's loop, op by op on the host, for a batch that may allocate
        past ``cap`` nodes.  There JAX's scatters drop the new node's writes
        while its parent still links its id (``>= cap``) and ``n`` keeps
        counting, and its gathers clamp: a descent through such an id
        reads node ``cap - 1``.  Where that read leads to an id ``>= cap``
        again, JAX's loop never ends; the port raises there instead."""
        dev = state.val.device
        cap = state.val.shape[0]
        val, left, right, mark = (_np(a).copy() for a in (
            state.val, state.left, state.right, state.mark))
        n, root, depth = int(state.n), int(state.root), state.depth
        res = np.zeros(len(keys_h), bool)

        def at(c: int) -> int:             # JAX's clamped gather
            return min(max(c, 0), cap - 1)

        for i, (k, v) in enumerate(zip(kinds_h, keys_h)):
            c, lev = root, 0
            while n > 0:                   # to the match or attach point
                x = int(val[at(c)])
                lev += 1
                nl = int((left if v < x else right)[at(c)])
                if x == v or nl < 0:
                    break
                if c >= cap and nl >= cap:
                    raise ValueError(
                        f"pointer_bst: key {v} descends past cap = {cap} "
                        f"into a cycle (JAX's loop never ends here)")
                c = nl
            x, marked = int(val[at(c)]), bool(mark[at(c)])
            hit = n > 0 and x == v
            if k == OP_INSERT:
                ok = marked if hit else True
                if hit and ok:
                    if c < cap:
                        mark[c] = False
                elif ok:
                    if n < cap:
                        val[n] = v
                    if n == 0:
                        root = n
                    elif c < cap:
                        (left if v < x else right)[c] = n
                    depth = max(depth, lev + 1)
                    n += 1
            else:
                ok = hit and not marked
                if ok and c < cap:
                    mark[c] = True
            res[i] = ok

        def dev_of(a):
            return torch.from_numpy(a).to(dev)

        return (PointerBSTState(
            dev_of(val), dev_of(left), dev_of(right), dev_of(mark),
            torch.tensor(n, dtype=torch.int32, device=dev),
            torch.tensor(root, dtype=torch.int32, device=dev), depth),
            dev_of(res))

    @staticmethod
    def _write(state: PointerBSTState, n: int, root: int, depth: int,
               mark: dict, new: dict, links: dict) -> PointerBSTState:
        dev = state.val.device
        cap = state.val.shape[0]
        val, left, right = state.val.clone(), state.left.clone(), \
            state.right.clone()
        marks = state.mark.clone()
        if new:
            ids = list(new)
            idx = torch.as_tensor(ids, dtype=torch.long, device=dev)
            val[idx] = _keys([new[i][0] for i in ids], dev)
            left[idx] = _keys([new[i][1] for i in ids], dev)
            right[idx] = _keys([new[i][2] for i in ids], dev)
        for (p, is_left), cid in links.items():
            if p >= 0:
                (left if is_left else right)[p] = cid
        if mark:
            ids = list(mark)
            marks[torch.as_tensor(ids, dtype=torch.long, device=dev)] = \
                torch.as_tensor([mark[i] for i in ids], device=dev)
        return PointerBSTState(
            val, left, right, marks,
            torch.tensor(n, dtype=torch.int32, device=dev),
            torch.tensor(root, dtype=torch.int32, device=dev), depth)

    @staticmethod
    def touch_fn(state: PointerBSTState):
        val = _np(state.val)
        left = _np(state.left)
        right = _np(state.right)
        root = int(state.root)
        n = int(state.n)

        def touched(key: int) -> list[int]:
            # each node = val + 2 pointers; model 4 elements per node
            out, c = [], root if n > 0 else -1
            while c >= 0:
                out.extend([4 * c, 4 * c + 1, 4 * c + 2])
                if val[c] == key:
                    break
                c = left[c] if key < val[c] else right[c]
            return out

        return touched


# --------------------------------------------------------------------------
# Open-addressing hash table (extra baseline, not in the paper)
# --------------------------------------------------------------------------


class HashState(NamedTuple):
    slots: torch.Tensor  # (cap,) int32, EMPTY free
    cap: int
    probe: int           # host bound: slots a search reads at most


class HashTable:
    name = "hash"
    TOMB = -1

    @staticmethod
    def _h(v: torch.Tensor, cap: int) -> torch.Tensor:
        """Knuth's multiplicative hash mod 2**32, then mod ``cap`` (the JAX
        uint32 arithmetic, in int64)."""
        return ((v.long() & 0xFFFFFFFF) * 2654435761 % 2**32 % cap).to(
            torch.int32)

    @staticmethod
    def build(values, cap: int | None = None, device=None) -> HashState:
        dev = resolve_device(device)
        values = np.unique(np.asarray(values, np.int32))
        cap = cap or int(2 ** np.ceil(np.log2(max(4 * len(values), 16))))
        slots = np.full(cap, EMPTY, np.int32)
        for v in values.tolist():
            i = (v * 2654435761) % (2**32) % cap
            while slots[i] != EMPTY:
                i = (i + 1) % cap
            slots[i] = v
        return HashState(torch.from_numpy(slots).to(dev), cap,
                         HashTable._probe_bound(slots))

    @staticmethod
    def _probe_bound(slots: np.ndarray) -> int:
        """Longest run of occupied slots (cyclic) + 1: no probe reads more
        before it finds its key or an EMPTY slot; at most ``cap``."""
        cap = slots.size
        occ = slots != EMPTY
        if occ.all():
            return cap
        ext = np.concatenate([occ, occ]).astype(np.int8)
        edges = np.diff(np.concatenate([[0], ext, [0]]))
        runs = np.flatnonzero(edges == -1) - np.flatnonzero(edges == 1)
        return min(cap, int(runs.max(initial=0)) + 1)

    @staticmethod
    def search(state: HashState, keys):
        slots, cap = state.slots, state.cap
        keys = _keys(keys, slots.device)
        i = HashTable._h(keys, cap).long()
        found = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
        active = torch.ones_like(found)
        for _ in range(state.probe):
            x = slots[i]
            found |= active & (x == keys)
            active &= (x != keys) & (x != EMPTY)
            i = (i + 1) % cap
        return found

    @staticmethod
    def touch_fn(state: HashState):
        slots = _np(state.slots)
        cap = state.cap

        def touched(key: int) -> list[int]:
            i = int((int(key) * 2654435761) % (2**32) % cap)
            out = []
            for _ in range(cap):
                out.append(i)
                if slots[i] == key or slots[i] == EMPTY:
                    break
                i = (i + 1) % cap
            return out

        return touched


ALL_BASELINES = [SortedArray, StaticVEB, PointerBST, HashTable]
