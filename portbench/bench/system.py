"""The system under test: the ΔTree index of ``repro_torch``, built
through ``repro_torch.api.make_index`` from a configuration file, and the
read calls a mix makes of it.

Also the control: the plain reference put in the program's place, with
its keys compared at a lower precision (`ReferenceSystem`).  A control
run drives it through the same client and the same comparison.
"""

from __future__ import annotations

import torch

from portbench.reference.sorted_index import SortedIndex


def arena_dnodes(config: dict, n_keys: int) -> int:
    """ΔNodes the arena holds (``benchmarks/common.py::backend_kwargs``:
    room for ``total_ops / 2`` fresh inserts, six ΔNodes of leaf capacity
    a key's share)."""
    arena = config["arena"]
    if arena["rule"] != "backend_kwargs":
        raise ValueError(f"unknown arena rule {arena['rule']!r}")
    height = int(config["index"]["height"])
    n_eff = n_keys + int(arena["total_ops"]) // 2
    return max(256, int(6 * n_eff / 2 ** (height - 1)))


def build(config: dict, ds, device):
    """The index over the dataset's initial keys, on ``device``."""
    from repro_torch.api import make_index

    kw = dict(config["index"])
    backend = kw.pop("backend")
    engine = kw.pop("engine")
    maintenance = kw.pop("maintenance")
    return make_index(backend, initial=ds.keys, payloads=ds.payloads,
                      engine=engine, maintenance=maintenance, device=device,
                      max_dnodes=arena_dnodes(config, ds.size), **kw)


def read_call(op: str, k: int):
    """``fn(ix, queries) -> (answers, hops)``: the answers the client
    brings to the host, and the hops column."""
    if op == "search":
        def fn(ix, q):
            found, hops = ix.search(q)[:2]
            return (found,), hops
    elif op == "lookup":
        def fn(ix, q):
            found, pay, hops = ix.lookup(q)[:3]
            return (found, pay), hops
    elif op == "successor_k":
        def fn(ix, q):
            keys, pays, n, hops, _ = ix.successor_k(q, k)
            return (keys, pays, n), hops
    else:
        raise ValueError(f"unknown read op {op!r}")
    return fn


def update_call(ix, kinds, keys, pays):
    """(index, per-row results, MaintenanceStats | None)."""
    from repro_torch.api import OpBatch

    return ix.update(OpBatch.mixed(kinds, keys, pays))


class ReferenceSystem:
    """The reference in the program's place: the index's read and update
    calls answered by `SortedIndex` with ``key_dtype`` rounding."""

    def __init__(self, ds, device, key_dtype):
        self.ref = SortedIndex(ds.keys, ds.payloads, device, key_dtype)
        self.device = torch.device(device)

    def _zeros(self, q):
        return torch.zeros(len(q), dtype=torch.int32, device=self.device)

    def search(self, q):
        return self.ref.search(q), self._zeros(q)

    def lookup(self, q):
        found, pay = self.ref.lookup(q)
        return found, pay.to(torch.int32), self._zeros(q)

    def successor_k(self, q, k):
        ks, ps, n = self.ref.successor_k(q, k)
        return (ks.to(torch.int32), ps.to(torch.int32), n.to(torch.int32),
                self._zeros(q), n >= k)

    def update(self, batch):
        return self, self.ref.apply(*batch), None

    def live_items(self):
        k, p = self.ref.items()
        return list(zip(k.tolist(), p.tolist()))

    def alloc_failed(self) -> bool:
        return False
