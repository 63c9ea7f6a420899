"""Hardware constants of the card the port runs on (port of the constants at
the end of ``repro.launch.mesh``), under the JAX module's names.

The JAX module's constants are a TPU v5e's; none is carried over.  Each
row here is keyed by the name ``nvidia-smi --query-gpu=name`` prints for
the card, and its numbers come from the vendor's data sheet (dense rates,
no sparsity, at the card's full power limit):

- NVIDIA H100 SXM5 80 GB ("NVIDIA H100 80GB HBM3", 700 W): 989 TFLOP/s
  dense bf16, 3.35 TB/s of HBM3, 80 GB, NVLink 4 at 900 GB/s a card
  both ways together, so 450 GB/s each way (``ICI_BW``: what one card
  sends to the others).

`card(name)` returns the row; an unknown card raises.

The meshes are ``torch.distributed`` device meshes over the ranks of the
default process group, under the JAX module's axis names:
`make_production_mesh` (JAX's two: 16 x 16 ("data", "model"), or 2 x 16
x 16 ("pod", "data", "model") with ``multi_pod``), `make_forest_mesh`
(the DeltaForest's 1-D "shards" mesh) and `make_host_mesh` (a ("data",
"model") mesh).  Without a process group
each gives a size-1 mesh.  A mesh's tensors live on the card unless the
caller names another device (`core.deltatree.resolve_device`), whatever
the backend.  The forest itself needs only the mesh's size,
`forest_ranks`, which is arithmetic and makes no group.
`start_process_group` starts the group with the backend its caller names
(or ``torchrun``'s environment gives); nothing here picks one.
`fake_process_group` is the dry-run's: a group of any size whose
collectives move nothing, this process its rank 0, so a production mesh
can be built on the meta device and a step's rank-0 ops counted
(`launch.dryrun`).  The collectives over a mesh's groups are
`parallel.comm`'s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.deltatree import resolve_device


@dataclasses.dataclass(frozen=True)
class Card:
    name: str               # as nvidia-smi --query-gpu=name prints it
    PEAK_FLOPS_BF16: float  # dense bf16 FLOP/s
    HBM_BW: float           # bytes/s of device memory
    HBM_PER_CHIP: float     # bytes of device memory
    ICI_BW: float           # bytes/s a card sends over NVLink


H100_SXM = Card(name="NVIDIA H100 80GB HBM3", PEAK_FLOPS_BF16=989e12,
                HBM_BW=3.35e12, HBM_PER_CHIP=80e9, ICI_BW=450e9)

CARDS = {c.name: c for c in (H100_SXM,)}


def card(name: str | None = None) -> Card:
    """The row of the card ``name``; with None, of the card present
    (``torch.cuda.get_device_name(0)``).  Raises when the card has no row,
    or when there is no card and no name."""
    if name is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present: name the card's row (one of "
                f"{sorted(CARDS)})")
        name = torch.cuda.get_device_name(0)
    try:
        return CARDS[name]
    except KeyError:
        raise KeyError(f"no constants for the card {name!r}; known: "
                       f"{sorted(CARDS)}") from None


# --------------------------------------------------------------------------
# process group and meshes
# --------------------------------------------------------------------------


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def start_process_group(backend: str, *, rank: int | None = None,
                        world_size: int | None = None,
                        init_method: str | None = None,
                        local_rank: int | None = None) -> None:
    """Start the default process group with ``backend``, which the caller
    names: ``"nccl"`` when every rank has a card of its own, ``"gloo"``
    otherwise (CPU ranks, or several ranks sharing one card; gloo moves
    CUDA tensors through the host).  Under nccl a rank takes the card of
    its rank on its host: ``local_rank``, else ``LOCAL_RANK`` from the
    environment (as ``torchrun`` sets it), else ``rank`` (one host).
    ``init_method`` is the rendezvous, e.g. ``"file:///tmp/store"`` or
    ``"tcp://localhost:29500"``.  Left out, ``rank``, ``world_size`` and
    the rendezvous come from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``)."""
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if init_method is None:
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    if backend == "nccl":
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", rank))
        cards = torch.cuda.device_count()
        if local_rank >= cards:
            raise ValueError(
                f"nccl needs a card for each rank of a host: local rank "
                f"{local_rank} of {world_size} ranks, and this host has "
                f"{cards}: name backend='gloo' to share cards")
        torch.cuda.set_device(local_rank)
    elif backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def _mesh(shape: tuple, names: tuple, device=None) -> DeviceMesh:
    """A device mesh of ``shape`` over ranks 0..prod(shape)-1 of the
    default group; a size-1 mesh needs no group (and makes none).  Its
    device type is ``device``'s: the card's by default (raises without
    one), under gloo too."""
    n = 1
    for d in shape:
        n *= d
    ranks = torch.arange(n).reshape(shape)
    kind = resolve_device(device).type
    if n == 1:
        return DeviceMesh(kind, ranks, mesh_dim_names=names,
                          _init_backend=False, _rank=0)
    return DeviceMesh(kind, ranks, mesh_dim_names=names)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device=None) -> DeviceMesh:
    """A ("data", "model") mesh over the first data * model ranks, whose
    tensors live on ``device``'s type (the card by default, under gloo
    too).  Every rank of the group calls it, those outside the mesh
    too."""
    _, w = world()
    if data * model > w:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks; the process group has {w}")
    return _mesh((data, model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """JAX's production mesh: (16, 16) ("data", "model"), or (2, 16, 16)
    ("pod", "data", "model") with ``multi_pod``, over the first 256 / 512
    ranks of the default group (a `fake_process_group` of that size for
    the dry-run), on ``device``'s type."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for d in shape:
        n *= d
    if n > world()[1]:
        raise ValueError(f"the production mesh {shape} needs {n} ranks; the "
                         f"process group has {world()[1]}")
    return _mesh(shape, names, device)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """The default group as ``world_size`` ranks of torch's fake backend,
    this process rank 0, for the block; destroyed on exit.  Its
    collectives return buffers of the right shapes and move nothing (on
    the meta device they touch no memory).  Raises where a group is
    running already."""
    if dist.is_initialized():
        raise RuntimeError("a process group is running already")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def forest_ranks(num_shards: int, world_size: int) -> int:
    """R, the ranks the DeltaForest's ``num_shards`` shards spread over:
    the largest divisor of ``num_shards`` that fits ``world_size``, so the
    shards always split evenly (S / R a rank)."""
    return max(d for d in range(1, min(world_size, num_shards) + 1)
               if num_shards % d == 0)


def make_forest_mesh(num_shards: int, *, device=None) -> DeviceMesh:
    """1-D "shards" mesh of `forest_ranks` ranks for the DeltaForest
    (`repro_torch.distributed`) on ``device``'s type (the card by
    default); ranks past the mesh hold a replica of mesh position rank
    mod R.  Without a process group (or with one rank) this is a size-1
    mesh: every shard on this process, as in unit tests."""
    return _mesh((forest_ranks(num_shards, world()[1]),), ("shards",),
                 device)
