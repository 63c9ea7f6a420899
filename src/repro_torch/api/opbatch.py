"""OpBatch — the batched op representation for the Index API (port of
``repro.api.opbatch``).

One step applies one ``OpBatch``: ``kinds[i]`` says what op row ``i`` is
(OP_SEARCH rows are no-ops inside ``insert_delete`` — they let a mixed
workload batch ride one update step), ``keys[i]`` the int32 key,
``payloads[i]`` the int32 payload (ignored by set-mode backends).  The
fields are int32 tensors; constructors place them on ``device`` (the CPU
when None) and the backend moves them to its index's device.

Row order is the linearization order: backends apply update rows in batch
order, and per-op results are reported in the same order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

OP_SEARCH, OP_INSERT, OP_DELETE = 0, 1, 2


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


class OpBatch(NamedTuple):
    """A batch of dictionary ops in linearization order (all (K,) int32)."""

    kinds: torch.Tensor     # OP_SEARCH | OP_INSERT | OP_DELETE per row
    keys: torch.Tensor      # int32 keys (>= 1; 0 is the EMPTY sentinel)
    payloads: torch.Tensor  # int32 payloads (map-mode backends only)

    @classmethod
    def mixed(cls, kinds, keys, payloads=None, device=None) -> "OpBatch":
        """Wrap parallel (kinds, keys[, payloads]) arrays; payloads default 0."""
        keys = _i32(keys, device)
        payloads = (torch.zeros_like(keys) if payloads is None
                    else _i32(payloads, keys.device))
        return cls(_i32(kinds, keys.device), keys, payloads)

    @classmethod
    def inserts(cls, keys, payloads=None, device=None) -> "OpBatch":
        keys = _i32(keys, device)
        return cls.mixed(torch.full_like(keys, OP_INSERT), keys, payloads)

    @classmethod
    def deletes(cls, keys, device=None) -> "OpBatch":
        keys = _i32(keys, device)
        return cls.mixed(torch.full_like(keys, OP_DELETE), keys)

    @property
    def size(self) -> int:
        return self.keys.shape[0]

    def to(self, device) -> "OpBatch":
        return OpBatch(*(x.to(device) for x in self))
