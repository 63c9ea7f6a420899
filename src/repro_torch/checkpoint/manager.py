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

from repro_torch.core.deltatree import resolve_device

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


def _load_leaf(path: Path, dtype: str) -> torch.Tensor:
    a = np.asarray(np.load(path), order="C")
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

    # ------------------------------------------------------------- saving ---

    def save(self, step: int, tree, extra: dict | None = None):
        """Snapshot to host (blocking) then write (async by default)."""
        flat = {k: _snapshot(v) for k, v in _flatten(tree).items()}
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, flat, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, extra or {})

    def wait(self):
        """Join the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
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

    def restore(self, step: int | None, skeleton, device=None):
        """Load the leaves of the skeleton's structure (its leaves' values
        are not read; the checkpoint may hold more) as tensors on
        ``device`` (the card unless the caller names another).  Returns
        (step, tree, extra)."""
        dev = resolve_device(device)
        if step is None:
            step = latest_step(self.dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = manifest["leaves"]
        flat = {k: _load_leaf(d / leaves[k]["file"],
                              leaves[k]["dtype"]).to(dev)
                for k in _flatten(skeleton)}
        tree = _unflatten_into(skeleton, flat)
        return manifest["step"], tree, manifest.get("extra", {})
