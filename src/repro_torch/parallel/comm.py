"""The collectives of the sharded trainer, and the only ones it runs:
`all_gather`, `reduce_scatter`, `all_reduce` and the checkpoint's
`gather`, each a plain ``torch.distributed`` call on a contiguous tensor
over a process group (a mesh dimension's, `ax.axis_of`).  Under NCCL the
tensors stay on the card; under gloo a CUDA tensor goes through gloo's
own CUDA path, which copies it to the host and back.  DTensor's
functional collectives are not used: over gloo with CUDA tensors its
all-gather crashed the process on the card (torch 2.11,
``tools/gloo_cuda_probe.py``).  `COUNTS` counts the calls by kind.

`recording()` collects a `Record` of each collective run under it: the
kind under JAX's HLO name, the bytes by JAX's convention (an all-reduce
its operand, an all-gather the gathered result, a reduce-scatter the
scattered block: `analysis.roofline.collective_stats` turns them into
wire bytes), the dtype, the shape of those bytes and the group's size.
`no_functional_collectives()` raises on any op of DTensor's functional
collectives, so a step that would fall back on DTensor's own rule fails
instead.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import warnings

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

COUNTS: collections.Counter = collections.Counter()
_SINKS: list = []
BUSY = [0]    # > 0 while a collective runs: the backend's own copies


@dataclasses.dataclass(frozen=True)
class Record:
    kind: str             # JAX's HLO name: "all-reduce", "all-gather", ...
    nbytes: int           # JAX's convention (the module's docstring)
    dtype: torch.dtype
    shape: tuple          # of the ``nbytes``
    group_size: int


@contextlib.contextmanager
def recording():
    """A list that gets a `Record` of each collective run in the block."""
    out: list = []
    _SINKS.append(out)
    try:
        yield out
    finally:
        _SINKS.remove(out)


@contextlib.contextmanager
def _running():
    """Marks the block as a collective's (the ops a backend dispatches
    inside one, such as gloo's copies into the result, on whatever
    thread, are not the step's: `analysis.count` leaves them out)."""
    BUSY[0] += 1
    try:
        yield
    finally:
        BUSY[0] -= 1


def _record(kind: str, t: torch.Tensor, n: int) -> None:
    if _SINKS:
        rec = Record(kind, t.numel() * t.element_size(), t.dtype,
                     tuple(t.shape), n)
        for sink in _SINKS:
            sink.append(rec)


FUNCTIONAL = ("_c10d_functional", "c10d_functional")


class _NoFunctional(TorchDispatchMode):
    """Raises on a functional collective; lets a DTensor's own handler run
    under the mode, so the collectives its rules would issue are seen
    (the error names the DTensor op whose rule issued it)."""

    def __init__(self):
        super().__init__()
        self.last = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace in FUNCTIONAL:
            raise RuntimeError(
                f"{func} ran: a DTensor rule communicated where the step's "
                f"collectives are parallel.comm's (in {self.last})")
        if any(issubclass(t, DTensor) for t in types):
            self.last = (str(func), [
                (tuple(a.placements), tuple(a.shape)) for a in args
                if isinstance(a, DTensor)])
            return NotImplemented
        return func(*args, **(kwargs or {}))


def no_functional_collectives():
    """A context in which any op of DTensor's functional collectives
    (``_c10d_functional`` / ``c10d_functional``) raises."""
    return _NoFunctional()

# torch 2.13 renames the two (the new names are missing from 2.11)
warnings.filterwarnings(
    "ignore", r"`torch\.distributed\.(all_gather_into_tensor|"
    r"reduce_scatter_tensor)` is deprecated", FutureWarning)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (or ``op="max"``) of ``x`` over ``group``, a new tensor on
    ``x``'s device."""
    COUNTS[f"all_reduce_{op}"] += 1
    y = x.detach().clone(memory_format=torch.contiguous_format)
    _record("all-reduce", y, dist.get_world_size(group))
    with _running():
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
    _record("all-gather", out, n)
    with _running():
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
    _record("reduce-scatter", out, n)
    with _running():
        dist.reduce_scatter_tensor(out, y, group=group)
    return out.movedim(0, dim)


def gather(x: torch.Tensor, dst: int = 0, group=None) -> list | None:
    """Every rank's ``x`` (equal shapes) of ``group`` (the default group by
    default), on rank ``dst`` only: a list in group-rank order, on ``x``'s
    device; None on the other ranks."""
    COUNTS["gather"] += 1
    y = x.detach().contiguous()
    rank = dist.get_rank(group)
    _record("gather", y, dist.get_world_size(group))
    parts = ([torch.empty_like(y) for _ in range(dist.get_world_size(group))]
             if rank == dst else None)
    with _running():
        dist.gather(y, parts, dst=dst, group=group)
    return parts
