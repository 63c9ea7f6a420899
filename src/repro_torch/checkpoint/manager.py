"""Checkpointing with atomic commit, async save and garbage collection
(port of ``repro.checkpoint.manager``), in the JAX package's format byte
for byte.

Format: one ``.npy`` a leaf of a nested dict / list / tuple tree (keys
``a.b`` for dict entries, ``[i]`` for sequence items; the file name is the
key) and ``manifest.json`` (step, time, extra — e.g. the data cursor —
and each leaf's file, shape and dtype).  Commit is write-to-tmp -> fsync
-> atomic rename, so a crash mid-save never corrupts the latest
checkpoint; the oldest beyond ``keep_last`` are removed.

Two things differ from the JAX code, not from its files:

- the snapshot is a copy (``detach().to("cpu", copy=True)``): the port's
  parameters change in place at the next step, and on the CPU ``.cpu()``
  would hand an async write the live storage;
- a bfloat16 leaf is written as JAX writes ml_dtypes' bfloat16: its 16-bit
  patterns under the ``.npy`` descr ``'<V2'``, dtype ``"bfloat16"`` in the
  manifest; `restore` reads such a leaf back through an int16 view into
  ``torch.bfloat16`` (JAX's own restore cannot: it hands the ``|V2`` array
  to ``device_put``).  Nothing here needs ml_dtypes.

Sharded trees (DTensor leaves, `repro_torch.parallel`): every rank of the
process group calls `save`; rank 0 gathers each sharded leaf's blocks
(`parallel.comm.gather`; the mesh must span the whole group) and writes
the files — byte for byte those of one process holding the same values —
and the others wait at a barrier (in `save` when it writes synchronously,
else in `wait`).  ``restore(..., shardings=)`` is the resharding restore:
each rank reads only its blocks of the files (memory-mapped) and places
them on the target mesh (`parallel.shardings.NamedSharding.place`),
whatever mesh wrote them.  ``last_save`` holds the last save's gather
and write seconds (the write's, synchronous ones only).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.deltatree import resolve_device
from repro_torch.parallel import comm as C
from repro_torch.parallel.ax import block_index

BF16 = "bfloat16"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = tree
    return out


def _unflatten_into(skeleton, flat):
    def walk(node, prefix=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}.{k}" if prefix else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(
                walk(v, f"{prefix}[{i}]") for i, v in enumerate(node))
        return flat[prefix]
    return walk(skeleton)


def latest_step(ckpt_dir) -> int | None:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*") if p.is_dir()]
    return max(steps) if steps else None


def _whole(v: DTensor, writer: bool):
    """A DTensor's whole value on the writer (rank 0), None elsewhere;
    every rank of the group calls it."""
    mesh = v.device_mesh
    if all(p.is_replicate() for p in v.placements):
        return v._local_tensor if writer else None
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a leaf on a mesh of {mesh.size()} of the "
                         f"group's {dist.get_world_size()} ranks: save "
                         "from a mesh over the whole group")
    parts = C.gather(v._local_tensor)
    if not writer:
        return None
    whole = torch.empty(v.shape, dtype=v.dtype, device=parts[0].device)
    shape = tuple(mesh.mesh.shape)
    for coord in np.ndindex(*shape):
        r = mesh.mesh[coord].item()
        whole[block_index(v.shape, shape, v.placements, coord)] = parts[r]
    return whole


def _snapshot(v):
    """(host array, manifest dtype) of a leaf: a copy, never a view of a
    tensor the trainer will change."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        a = t.numpy()
    else:
        a = np.array(v)
    return a, str(a.dtype)


def _save_leaf(path: Path, a: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(path, a)
        return
    # ml_dtypes' bfloat16 saves as descr '<V2': the same header, raw bits
    header = np.lib.format.header_data_from_array_1_0(a)
    header["descr"] = "<V2"
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(np.ascontiguousarray(a).tobytes())


def _load_leaf(path: Path, dtype: str, sharding=None) -> torch.Tensor:
    """A leaf's whole tensor, or with ``sharding`` (a `NamedSharding`)
    this rank's block of it, read through a memory map."""
    a = np.load(path, mmap_mode="r" if sharding is not None else None)
    if sharding is not None:
        mesh = sharding.mesh
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        a = a[block_index(a.shape, tuple(mesh.mesh.shape),
                          sharding.placements, coord)]
    a = np.array(a, order="C", copy=True) if sharding is not None \
        else np.asarray(a, order="C")
    if dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, ckpt_dir, keep_last: int = 3, async_save: bool = True):
        self.dir = Path(ckpt_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._barrier = False
        self.last_save: dict = {}

    # ------------------------------------------------------------- saving ---

    def save(self, step: int, tree, extra: dict | None = None):
        """Snapshot to host (blocking) then write (async by default).  A
        tree with sharded leaves: every rank calls it, rank 0 writes."""
        t0 = time.perf_counter()
        leaves = _flatten(tree)
        group = (dist.is_available() and dist.is_initialized()
                 and any(isinstance(v, DTensor) for v in leaves.values()))
        writer = not group or dist.get_rank() == 0
        flat = {}
        for k, v in leaves.items():
            if isinstance(v, DTensor):
                v = _whole(v, writer)       # collective: every rank
            if writer:
                flat[k] = _snapshot(v)
        self.last_save = {"gather_s": time.perf_counter() - t0}
        self.wait()
        self._barrier = group
        t0 = time.perf_counter()
        if writer and self.async_save:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, flat, extra or {}),
                daemon=True)
            self._thread.start()
        elif writer:
            self._write(step, flat, extra or {})
        if group and not self.async_save:
            self.wait()
        if not self.async_save:
            self.last_save["write_s"] = time.perf_counter() - t0

    def wait(self):
        """Join the write in flight (and, after a sharded save, wait for
        every rank); raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_async(self, step: int, flat: dict, extra: dict):
        try:
            self._write(step, flat, extra)
        except BaseException as e:     # re-raised by `wait`
            self._error = e

    def _write(self, step: int, flat: dict, extra: dict):
        tmp = self.dir / f".tmp_step_{step}_{os.getpid()}"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "extra": extra,
                    "leaves": {}}
        for k, (v, dtype) in flat.items():
            fn = k.replace("/", "_") + ".npy"
            _save_leaf(tmp / fn, v, dtype)
            manifest["leaves"][k] = {
                "file": fn, "shape": list(v.shape), "dtype": dtype}
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic commit
        self._gc()

    def _gc(self):
        steps = sorted(p for p in self.dir.glob("step_*") if p.is_dir())
        for p in steps[: -self.keep_last]:
            shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------ restore ---

    def restore(self, step: int | None, skeleton, device=None,
                shardings=None):
        """Load the leaves of the skeleton's structure (its leaves' values
        are not read; the checkpoint may hold more) as tensors on
        ``device`` (the card unless the caller names another), or, with
        ``shardings`` (a tree of `parallel.shardings.NamedSharding` like
        the skeleton), as this rank's blocks on their meshes.  Returns
        (step, tree, extra)."""
        dev = None if shardings is not None else resolve_device(device)
        if step is None:
            step = latest_step(self.dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = manifest["leaves"]
        places = _flatten(shardings) if shardings is not None else None
        flat = {}
        for k in _flatten(skeleton):
            sh = None if places is None else places[k]
            if sh is not None and not leaves[k]["shape"]:
                sh = None                       # a 0-d leaf: whole
            t = _load_leaf(d / leaves[k]["file"], leaves[k]["dtype"], sh)
            if places is None:
                flat[k] = t.to(dev)
            elif sh is None:
                flat[k] = places[k].place(t, device)
            else:
                flat[k] = places[k].place_block(t, device)
        tree = _unflatten_into(skeleton, flat)
        return manifest["step"], tree, manifest.get("extra", {})
