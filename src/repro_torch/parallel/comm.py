"""The collectives of the sharded trainer, and the only ones it runs:
`all_gather`, `reduce_scatter`, `all_reduce` and the checkpoint's
`gather`, each a plain ``torch.distributed`` call on a contiguous tensor
over a process group (a mesh dimension's, `ax.axis_of`).  Under NCCL the
tensors stay on the card; under gloo a CUDA tensor goes through gloo's
own CUDA path, which copies it to the host and back.  DTensor's
functional collectives are not used: over gloo with CUDA tensors its
all-gather crashed the process on the card (torch 2.11,
``tools/gloo_cuda_probe.py``).  `COUNTS` counts the calls by kind.
"""

from __future__ import annotations

import collections
import warnings

import torch
import torch.distributed as dist

COUNTS: collections.Counter = collections.Counter()

# torch 2.13 renames the two (the new names are missing from 2.11)
warnings.filterwarnings(
    "ignore", r"`torch\.distributed\.(all_gather_into_tensor|"
    r"reduce_scatter_tensor)` is deprecated", FutureWarning)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (or ``op="max"``) of ``x`` over ``group``, a new tensor on
    ``x``'s device."""
    COUNTS[f"all_reduce_{op}"] += 1
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return y


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in
    group-rank order."""
    n = dist.get_world_size(group)
    COUNTS["all_gather"] += 1
    y = x.detach().movedim(dim, 0).contiguous()
    out = y.new_empty((n * y.shape[0],) + tuple(y.shape[1:]))
    dist.all_gather_into_tensor(out, y, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over ``group``, cut along ``dim`` into as many
    equal blocks as the group has ranks; this rank's block."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    COUNTS["reduce_scatter"] += 1
    y = x.detach().movedim(dim, 0).contiguous()
    out = y.new_empty((y.shape[0] // n,) + tuple(y.shape[1:]))
    dist.reduce_scatter_tensor(out, y, group=group)
    return out.movedim(0, dim)


def gather(x: torch.Tensor, dst: int = 0, group=None) -> list | None:
    """Every rank's ``x`` (equal shapes) of ``group`` (the default group by
    default), on rank ``dst`` only: a list in group-rank order, on ``x``'s
    device; None on the other ranks."""
    COUNTS["gather"] += 1
    y = x.detach().contiguous()
    rank = dist.get_rank(group)
    parts = ([torch.empty_like(y) for _ in range(dist.get_world_size(group))]
             if rank == dst else None)
    dist.gather(y, parts, dst=dst, group=group)
    return parts
