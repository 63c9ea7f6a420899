"""PyTorch port: export hygiene against the JAX package (mirrors
tests/test_exports.py).  Each ``repro_torch.<pkg>.__all__`` resolves with
no duplicates and holds every name of ``repro.<pkg>.__all__`` but the ones
listed in JAX_ONLY; the ``core`` and ``distributed`` shims warn and
resolve as JAX's do; ``supported_maintenance`` equals JAX's for every
registered backend.  JAX's ``__all__`` is read from its source with
``ast``, so only the last test imports JAX."""

import ast
import importlib
import json
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

from test_exports import PACKAGES

ROOT = Path(__file__).resolve().parent.parent
PORT_PACKAGES = [p.replace("repro.", "repro_torch.", 1) for p in PACKAGES]

# names of a JAX ``__all__`` the port leaves out, each with its reason
JAX_ONLY = {
    "repro.kernels": {
        "default_interpret": "chooses Pallas's interpreter (interpret=True "
                             "off the TPU); the port's wrappers run the "
                             "plain version for a CPU tensor instead",
    },
}


def jax_all(pkg: str) -> list[str]:
    """``__all__`` of a JAX package, read from its ``__init__.py``."""
    path = ROOT / "src" / Path(*pkg.split(".")) / "__init__.py"
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    raise AssertionError(f"{pkg} declares no __all__")


@pytest.mark.parametrize("pkg", PORT_PACKAGES)
def test_every_all_name_resolves(pkg):
    mod = importlib.import_module(pkg)
    assert hasattr(mod, "__all__"), f"{pkg} must declare __all__"
    assert len(set(mod.__all__)) == len(mod.__all__), f"{pkg}: duplicate names"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for name in mod.__all__:
            obj = getattr(mod, name)  # raises AttributeError on drift
            assert obj is not None, f"{pkg}.{name} resolved to None"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_all_holds_jax_all(pkg):
    port = importlib.import_module(pkg.replace("repro.", "repro_torch.", 1))
    jax_names = jax_all(pkg)
    left_out = JAX_ONLY.get(pkg, {})
    assert set(left_out) <= set(jax_names), (pkg, left_out)
    missing = [n for n in jax_names
               if n not in port.__all__ and n not in left_out]
    assert not missing, (pkg, missing)
    assert not set(left_out) & set(port.__all__), (pkg, left_out)


def test_core_shim_warns_and_resolves():
    import repro_torch.core
    from repro_torch.core import deltatree

    for name in ("update_batch", "search_jit", "successor_jit", "flush"):
        with pytest.warns(DeprecationWarning, match="make_index"):
            fn = getattr(repro_torch.core, name)
        assert fn is getattr(deltatree, name)
    # stable names never warn
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        _ = (repro_torch.core.TreeConfig, repro_torch.core.OP_INSERT,
             repro_torch.core.layout, repro_torch.core.engine,
             repro_torch.core.get_engine)
        from repro_torch.core import TreeConfig  # noqa: F401


def test_distributed_shim_warns_and_resolves():
    import repro_torch.distributed
    from repro_torch.distributed import forest

    with pytest.warns(DeprecationWarning, match="make_index"):
        fn = repro_torch.distributed.search_batch
    assert fn is forest.search_batch
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        _ = repro_torch.distributed.ForestConfig, repro_torch.distributed.router


def test_unknown_attribute_still_raises():
    import repro_torch.core
    import repro_torch.distributed

    with pytest.raises(AttributeError):
        _ = repro_torch.core.not_a_real_name
    with pytest.raises(AttributeError):
        _ = repro_torch.distributed.not_a_real_name


def test_jit_names_call_the_batch_functions():
    """``search_jit`` / ``lookup_jit`` / ``successor_jit`` take JAX's
    ``(cfg, t, keys)`` and give the batch functions' results."""
    import numpy as np

    from repro_torch.core import deltatree as DT

    cfg = DT.TreeConfig(height=4, max_dnodes=64, payload_bits=8)
    t = DT.bulk_build(cfg, np.arange(2, 40, 3), np.arange(13) % 7,
                      device="cpu")
    q = np.arange(0, 44, dtype=np.int32)
    for jit, batch in ((DT.search_jit, DT.search_batch),
                       (DT.lookup_jit, DT.lookup_batch),
                       (DT.successor_jit, DT.successor_batch)):
        for a, b in zip(jit(cfg, t, q), batch(cfg, t, q)):
            assert a.equal(b), jit.__name__


def test_each_package_imports_first():
    """Every package (and the kernel modules) imports as the first module
    of the port in a process, so no order of imports meets a cycle, and
    importing ``repro_torch.kernels`` builds and loads no kernel."""
    first = PORT_PACKAGES + [
        "repro_torch.kernels.ref", "repro_torch.kernels.ops",
        "repro_torch.kernels.veb_search", "repro_torch.core.deltatree",
        "repro_torch.maintenance.scheduler", "repro_torch.core.baselines"]
    code = f"""
import importlib, json, sys
import torch
bad = []
for m in {first!r}:
    for k in [k for k in sys.modules if k.startswith("repro_torch")]:
        del sys.modules[k]
    try:
        importlib.import_module(m)
    except Exception as e:
        bad.append([m, repr(e)])
from repro_torch.kernels import build
print(json.dumps({{"bad": bad, "loaded": sorted(build._LOADED)}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "loaded": []}


def test_supported_maintenance_equals_jax():
    from repro.api import available_backends as javailable
    from repro.api import supported_maintenance as jsupported
    from repro_torch.api import available_backends, supported_maintenance

    assert available_backends() == javailable()
    for backend in available_backends():
        assert supported_maintenance(backend) == jsupported(backend), backend
