"""The plain reference of an ordered index: a sorted array of keys with
their payloads, in plain PyTorch on any device.

It has the index's semantics and nothing of its structure:

- ``search`` / ``lookup``: membership, and the payload (-1 where absent);
- ``successor_k``: per query the ``k`` smallest keys strictly above it,
  rows zero-padded past their count;
- ``apply``: a batch of inserts and deletes in batch order, so a key
  updated twice in one batch sees its own earlier op.  An insert of a
  present key changes nothing and answers False; a delete of an absent
  key answers False.  Rows of kind 0 are no-ops (answer False).

``key_dtype`` makes the lower-precision control: every key comparison is
made on keys rounded through that floating type, as an index that keyed
on floats would make them.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

OP_SEARCH, OP_INSERT, OP_DELETE = 0, 1, 2


class SortedIndex:
    def __init__(self, keys, payloads=None, device="cpu", key_dtype=None):
        self.device = torch.device(device)
        self.key_dtype = key_dtype
        k = torch.as_tensor(np.asarray(keys, np.int64), device=self.device)
        p = (torch.zeros_like(k) if payloads is None else
             torch.as_tensor(np.asarray(payloads, np.int64), device=self.device))
        order = torch.argsort(k)
        self.keys, self.pays = k[order], p[order]

    # ---- key comparison ----

    def _cmp(self, k: torch.Tensor) -> torch.Tensor:
        """Keys as compared: themselves, or rounded through ``key_dtype``."""
        if self.key_dtype is None:
            return k
        return k.to(self.key_dtype).to(torch.int64)

    def _t(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.int64)
        return torch.as_tensor(np.asarray(x, np.int64), device=self.device)

    def _find(self, q: torch.Tensor):
        """(index of the first stored key comparing equal, present)."""
        sk = self._cmp(self.keys)
        cq = self._cmp(q)
        i = torch.searchsorted(sk, cq)
        ic = i.clamp(max=max(sk.numel() - 1, 0))
        hit = (i < sk.numel()) & (sk[ic] == cq) if sk.numel() else \
            torch.zeros_like(q, dtype=torch.bool)
        return ic, hit

    # ---- reads ----

    def search(self, keys) -> torch.Tensor:
        return self._find(self._t(keys))[1]

    def lookup(self, keys):
        """(found, payload with -1 where absent)."""
        i, hit = self._find(self._t(keys))
        pay = self.pays[i] if self.keys.numel() else torch.zeros_like(i)
        return hit, torch.where(hit, pay, -1)

    def successor_k(self, keys, k: int):
        """(keys (K, k), payloads (K, k), n (K,)): the k smallest stored
        keys strictly above each query, zero-padded past n."""
        q = self._t(keys)
        n_all = self.keys.numel()
        start = torch.searchsorted(self._cmp(self.keys), self._cmp(q),
                                   right=True)
        idx = start[:, None] + torch.arange(k, device=self.device)[None, :]
        valid = idx < n_all
        idx = idx.clamp(max=max(n_all - 1, 0))
        ks = torch.where(valid, self.keys[idx], 0) if n_all else \
            torch.zeros_like(idx)
        ps = torch.where(valid, self.pays[idx], 0) if n_all else \
            torch.zeros_like(idx)
        return ks, ps, valid.sum(1)

    # ---- updates ----

    def apply(self, kinds, keys, payloads=None) -> torch.Tensor:
        """Apply one batch in batch order; returns each row's result."""
        kinds, keys = self._t(kinds), self._t(keys)
        pays = torch.zeros_like(keys) if payloads is None else \
            self._t(payloads)
        res = torch.zeros(keys.numel(), dtype=torch.bool, device=self.device)
        rows = (kinds != OP_SEARCH).nonzero()[:, 0]
        if rows.numel() == 0:
            return res
        # a stable sort by key keeps batch order within each key's group
        ks, order = torch.sort(self._cmp(keys[rows]), stable=True)
        rows = rows[order]
        kd, pv, kt = kinds[rows], pays[rows], keys[rows]
        m = ks.numel()
        first = torch.ones(m, dtype=torch.bool, device=self.device)
        first[1:] = ks[1:] != ks[:-1]
        last = torch.ones_like(first)
        last[:-1] = first[1:]
        _, before = self._find(kt)
        prev_kind = torch.roll(kd, 1)
        present = torch.where(first, before, prev_kind == OP_INSERT)
        ok = torch.where(kd == OP_INSERT, ~present, present)
        res[rows] = ok
        # per key: present at the end iff its last op inserts; its payload
        # is its last successful insert's, else the stored one
        pos = torch.arange(m, device=self.device)
        gstart = torch.cummax(torch.where(first, pos, 0), 0).values
        si = torch.cummax(torch.where(ok & (kd == OP_INSERT), pos, -1),
                          0).values
        fresh = si >= gstart
        ends = last.nonzero()[:, 0]
        end_present = kd[ends] == OP_INSERT
        old_i, old_hit = self._find(kt[ends])
        old_pay = self.pays[old_i] if self.keys.numel() else \
            torch.zeros_like(old_i)
        end_pay = torch.where(fresh[ends], pv[si[ends].clamp(min=0)], old_pay)
        # drop every touched key, then merge the present ones back in
        keep = torch.ones(self.keys.numel(), dtype=torch.bool,
                          device=self.device)
        keep[old_i[old_hit]] = False
        self._merge(self.keys[keep], self.pays[keep], kt[ends][end_present],
                    end_pay[end_present])
        return res

    def _merge(self, ok_, op_, nk, np_):
        """Sorted (ok_, op_) with sorted new (nk, np_), by compared key."""
        order = torch.argsort(self._cmp(nk), stable=True)
        nk, np_ = nk[order], np_[order]
        n = ok_.numel() + nk.numel()
        at = torch.searchsorted(self._cmp(ok_), self._cmp(nk)) + torch.arange(
            nk.numel(), device=self.device)
        is_new = torch.zeros(n, dtype=torch.bool, device=self.device)
        is_new[at] = True
        keys = torch.empty(n, dtype=torch.int64, device=self.device)
        pays = torch.empty_like(keys)
        keys[at], pays[at] = nk, np_
        keys[~is_new], pays[~is_new] = ok_, op_
        self.keys, self.pays = keys, pays

    def items(self):
        """(keys, payloads) as sorted int64 numpy arrays."""
        return self.keys.cpu().numpy(), self.pays.cpu().numpy()
