"""The one generator of traffic: it reads a mix's parameters
(``portbench/traffic/<mix>.json``) and draws every step's inputs from the
seed during set-up, into pinned host memory.

A step is one read call of ``batch`` rows or a share of them, then, where
the mix has updates, one update call:

- ``reads.op``: ``search`` (membership), ``lookup`` (key -> payload) or
  ``successor_k`` (the ``k`` smallest keys above each query; the client
  keeps the first ``length`` of them, a YCSB scan from a start key);
- ``reads.keys.dist``: ``uniform`` over the configuration's key range, or
  ``scrambled_zipfian`` over its records (YCSB's request distribution);
- ``updates.kind``: ``mixed`` (``pct`` % of each step's rows are
  updates, ``insert_share`` of them inserts and the rest deletes, at rows
  drawn anew each step, on the step's own keys; the whole batch goes to
  the update call with its read rows as no-ops) or
  ``insert_fresh`` (the rows past the reads insert records not yet in the
  table, with their row ids).

Read batches cycle through a pool of ``pool_steps`` batches when nothing
ties them to the updates.  Update batches never repeat: ``max_steps``
of them are drawn, and a run that would need more fails.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.traffic import ycsb

OP_SEARCH, OP_INSERT, OP_DELETE = 0, 1, 2


@dataclasses.dataclass
class Stream:
    batch: int
    read_op: str
    k: int                          # successor_k rows per query
    read_keys: torch.Tensor         # (pool, R) int32 queries
    lengths: np.ndarray | None      # (pool, R) kept rows per successor_k query
    update_kind: str | None
    upd_kinds: torch.Tensor | None  # (max_steps, U) int32
    upd_keys: torch.Tensor | None
    upd_pays: torch.Tensor | None
    n_reads: np.ndarray             # read ops a step (per pool row or step)
    n_writes: np.ndarray            # update ops a step
    max_steps: int | None           # None: reads only, the pool cycles

    @property
    def pool(self) -> int:
        return self.read_keys.shape[0]

    def row(self, i: int) -> int:
        return i % self.pool

    def reads(self, i: int) -> torch.Tensor:
        return self.read_keys[self.row(i)]

    def updates(self, i: int):
        """(kinds, keys, payloads) of step ``i``, or None."""
        if self.update_kind is None:
            return None
        if i >= self.max_steps:
            raise RuntimeError(
                f"the mix's {self.max_steps} update batches are spent: "
                "raise max_steps in its traffic file")
        return self.upd_kinds[i], self.upd_keys[i], self.upd_pays[i]

    def ops(self, i: int) -> tuple[int, int]:
        """(read ops, update ops) of step ``i``."""
        j = self.row(i)
        w = 0 if self.update_kind is None else int(self.n_writes[i])
        return int(self.n_reads[j]), w


def _pinned(a: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t


def draw_keys(spec: dict, ds, rng, shape) -> np.ndarray:
    """Query keys by ``spec["dist"]``."""
    n = int(np.prod(shape))
    dist = spec["dist"]
    if dist == "uniform":
        out = rng.integers(1, ds.key_max, size=n, dtype=np.int64)
    elif dist == "scrambled_zipfian":
        idx = ycsb.scrambled_zipfian(rng, n, ds.records.size,
                                     float(spec["theta"]))
        out = ds.records[idx]
    else:
        raise ValueError(f"unknown key distribution {dist!r}")
    return out.reshape(shape)


def fresh_needed(traffic: dict) -> int:
    """Records an ``insert_fresh`` mix holds back for its inserts."""
    upd = traffic["updates"]
    if not upd or upd["kind"] != "insert_fresh":
        return 0
    b = int(traffic["batch"])
    return int(traffic["max_steps"]) * (b - round(b * traffic["reads"]["share"]))


def make(traffic: dict, ds, rng, device) -> Stream:
    b = int(traffic["batch"])
    reads, upd = traffic["reads"], traffic["updates"]
    op = reads["op"]
    kind = upd["kind"] if upd else None
    k, lengths = int(reads.get("k", 0)), None
    upd_kinds = upd_keys = upd_pays = None
    max_steps = None
    if kind == "mixed":
        # reads and updates share the step's keys: every step is drawn
        steps = int(traffic["max_steps"])
        keys = draw_keys(reads["keys"], ds, rng, (steps, b))
        # the same count of inserts and of deletes every step, at rows
        # drawn anew each step
        nu = round(b * float(upd["pct"]) / 100.0)
        ni = round(nu * float(upd["insert_share"]))
        row = np.full(b, OP_SEARCH)
        row[:ni], row[ni:nu] = OP_INSERT, OP_DELETE
        kinds = rng.permuted(np.tile(row, (steps, 1)), axis=1)
        read_keys = _pinned(keys, device)
        upd_kinds, upd_keys = _pinned(kinds, device), read_keys
        upd_pays = _pinned(np.zeros((steps, b), np.int32), device)
        n_reads = (kinds == OP_SEARCH).sum(1)
        n_writes = b - n_reads
        max_steps = steps
    else:
        pool = int(traffic["pool_steps"])
        nr = round(b * float(reads["share"]))
        q = draw_keys(reads["keys"], ds, rng, (pool, nr))
        if op == "successor_k":
            lo, hi = reads["lengths"]
            lengths = ycsb.uniform_lengths(rng, pool * nr, lo, hi).reshape(
                pool, nr)
            q = q - 1      # successors strictly above start - 1: from start
        read_keys = _pinned(q, device)
        n_reads = np.full(pool, nr)
        n_writes = np.zeros(0, np.int64)
        if kind == "insert_fresh":
            steps = int(traffic["max_steps"])
            nu = b - nr
            fk = ds.fresh_keys[: steps * nu]
            if fk.size < steps * nu:
                raise ValueError("the configuration holds back too few records")
            upd_keys = _pinned(fk.reshape(steps, nu), device)
            upd_pays = _pinned(ds.fresh_ids[: steps * nu].reshape(steps, nu),
                               device)
            upd_kinds = _pinned(np.full((steps, nu), OP_INSERT), device)
            n_writes = np.full(steps, nu)
            max_steps = steps
        elif kind is not None:
            raise ValueError(f"unknown update kind {kind!r}")
    return Stream(batch=b, read_op=op, k=k, read_keys=read_keys,
                  lengths=lengths, update_kind=kind, upd_kinds=upd_kinds,
                  upd_keys=upd_keys, upd_pays=upd_pays, n_reads=n_reads,
                  n_writes=n_writes, max_steps=max_steps)
