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
    """All 16 arena arrays equal, dtypes and shapes included."""
    from repro_torch.core.deltatree import to_numpy

    a, b = jax_arrays(jt), to_numpy(tt)
    assert set(a) == set(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, (where, name)
        assert a[name].shape == b[name].shape, (where, name)
        np.testing.assert_array_equal(a[name], b[name],
                                      err_msg=f"{where}: {name}")


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
