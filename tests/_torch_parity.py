"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py):
carry a JAX ``DeltaTree`` and its ``TreeConfig`` over to the port, and
compare trees array by array.  Both packages get the same numpy inputs."""

from __future__ import annotations

import dataclasses

import numpy as np


def port_cfg(jcfg):
    """The port's TreeConfig with every field of the JAX one."""
    from repro_torch.core.deltatree import TreeConfig

    return TreeConfig(**dataclasses.asdict(jcfg))


def jax_arrays(jt) -> dict:
    return {k: np.asarray(v) for k, v in jt._asdict().items()}


def to_port(jcfg, jt, device="cpu"):
    """(port cfg, port tree) holding exactly the JAX tree's state."""
    from repro_torch.core.deltatree import from_numpy

    cfg = port_cfg(jcfg)
    return cfg, from_numpy(cfg, jax_arrays(jt), device)


def assert_trees_equal(jt, tt, where="") -> None:
    """All 16 arena arrays equal, dtypes and shapes included.  ``jt`` is a
    JAX tree or its arrays as a dict of numpy arrays (as a subprocess
    passes them back)."""
    from repro_torch.core.deltatree import to_numpy

    a = jt if isinstance(jt, dict) else jax_arrays(jt)
    b = to_numpy(tt)
    assert set(a) == set(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, (where, name)
        assert a[name].shape == b[name].shape, (where, name)
        np.testing.assert_array_equal(a[name], b[name],
                                      err_msg=f"{where}: {name}")


DEEP_KEYS = 600    # chip_smoke.py's DEEP_KEYS


def deep_tree(payload_bits: int, n_keys: int = DEEP_KEYS):
    """(cfg, port tree on the CPU): height 3 (four leaves a ΔNode) after
    ``n_keys`` ascending inserts in batches of 50, then deletes among the
    top 40 keys.  Each batch hangs below a longer chain of ΔNodes, so the
    paths to the top 50 keys run 40-70 ΔNodes deep, past the scan kernel's
    32-entry path stack, and the deletes leave tombstones there.  The tree
    of ``chip_smoke.py``'s ``deep_scan_check``."""
    from repro_torch.core import deltatree as DT

    cfg = DT.TreeConfig(height=3, max_dnodes=4096, buf_cap=8,
                        payload_bits=payload_bits, engine="lockstep")
    t = DT.bulk_build(cfg, np.arange(1, 5, dtype=np.int32),
                      np.arange(1, 5) if payload_bits else None, device="cpu")
    for s in range(0, n_keys, 50):
        keys = np.arange(10 + s, 60 + s, dtype=np.int32)
        t, _, _ = DT.update_batch(cfg, t, np.ones(50, np.int32), keys,
                                  keys % 97)
    dels = np.arange(n_keys - 30, n_keys + 10, 3, dtype=np.int32)
    t, _, _ = DT.update_batch(cfg, t, np.full(dels.size, 2, np.int32), dels)
    return cfg, t


def np_of(x) -> np.ndarray:
    """A JAX array or a torch tensor as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_cols_equal(a_cols, b_cols, names, where="") -> None:
    for name, a, b in zip(names, a_cols, b_cols):
        a, b = np_of(a), np_of(b)
        assert a.dtype == b.dtype, (where, name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}: {name}")


def shared_npz(tmp_path_factory, name: str, make) -> dict:
    """``make(path)`` writes an ``.npz`` once per test run, shared by every
    pytest-xdist worker (the first worker to ask runs it under a file lock,
    the others wait and read); returns its arrays.  For the JAX side of a
    parity test that runs in a subprocess."""
    import fcntl
    import os

    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / f"{name}.npz"
    with open(root / f"{name}.lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if not path.exists():
                make(path)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def prefixed(arrays: dict, prefix: str) -> dict:
    """The entries of ``arrays`` under ``prefix/``, with it stripped."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in arrays.items() if k.startswith(prefix + "/")}


def jax_npz(tmp_path_factory, name: str, code: str, x64: bool = True) -> dict:
    """Run ``code`` (which fills a dict ``rec`` with numpy arrays) in a
    subprocess, once per test run for every xdist worker (`shared_npz`),
    and return ``rec``.  For JAX sides that need x64."""
    import os

    from _subproc import run_py

    def make(path):
        tmp = f"{path}.part.npz"
        run_py(f"{code}\nimport numpy as _np\n_np.savez({tmp!r}, **rec)\n",
               x64=x64, timeout=900)
        os.replace(tmp, path)

    return shared_npz(tmp_path_factory, name, make)


# pager stats in a fixed order (the JAX and the port pager count the same)
STAT_KEYS = ("searches", "inserts", "deletes", "hops", "flushes",
             "maint_rebuilds", "maint_expands", "maint_merges", "combined",
             "inline_maint")

# The start of every serving scenario's JAX side: the smoke model's params
# (recorded under ``param/`` in the port's state_dict names) and
# ``pager_state``, which records a pager's stats, free list and arena.
SERVE_PRELUDE = f"STAT_KEYS = {STAT_KEYS!r}\n" + r'''
import numpy as np, jax
from repro.configs import get_smoke_config
from repro.models.registry import api
from repro_torch.models.weights import jax_state_dict
rec = {}
def pager_state(prefix, pg):
    rec[f"{prefix}/stats"] = np.asarray([pg.stats[k] for k in STAT_KEYS])
    rec[f"{prefix}/free"] = np.asarray(pg.free_pages, np.int64)
    for k, v in pg.index.state._asdict().items():
        rec[f"{prefix}/tree/{k}"] = np.asarray(v)
cfg = get_smoke_config("granite_8b")
m = api(cfg)
params = m.init_params(jax.random.PRNGKey(0))
for k, v in jax_state_dict(cfg, jax.tree.map(np.asarray, params)).items():
    rec["param/" + k] = np.asarray(v)
'''


def serve_model(rec):
    """The port's smoke Granite with the weights a JAX side recorded under
    ``param/``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import Transformer
    from repro_torch.models.weights import load_state

    cfg = get_smoke_config("granite_8b")
    return load_state(Transformer(cfg, device="cpu", init=False),
                      prefixed(rec, "param"))


def check_pager(rec, prefix: str, pg) -> None:
    """A port pager's stats, free list and 16 arena arrays equal what
    ``pager_state(prefix, ...)`` recorded on the JAX side."""
    np.testing.assert_array_equal(rec[f"{prefix}/stats"],
                                  [pg.stats[k] for k in STAT_KEYS],
                                  err_msg=f"{prefix}: pager stats")
    np.testing.assert_array_equal(rec[f"{prefix}/free"], pg.free_pages,
                                  err_msg=f"{prefix}: free list")
    assert_trees_equal(prefixed(rec, f"{prefix}/tree"), pg.index.state,
                       prefix)
