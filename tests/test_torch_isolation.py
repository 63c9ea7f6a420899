"""PyTorch port: the package and ``chip_smoke.py`` stand alone — they import
neither jax nor the JAX package — and no CUDA wrapper catches a failure to
fall back to its plain version."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"


def _modules() -> list[str]:
    mods = []
    for path in PKG.rglob("*.py"):
        parts = path.relative_to(PKG.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                             else parts))
    return sorted(mods)


def test_imports_without_jax_or_repro():
    """Every port module imports in a process where ``jax`` and ``repro``
    cannot be imported, and ``chip_smoke.py`` parses there too."""
    code = f"""
import ast, importlib, json, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of these now fails
mods = {_modules()!r}
for m in mods:
    importlib.import_module(m)
ast.parse(open({str(ROOT / "chip_smoke.py")!r}).read())
print(json.dumps({{"imported": len(mods),
                  "jax": [m for m in sys.modules if m.split(".")[0] in
                          ("jax", "jaxlib", "repro") and sys.modules[m]]}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["imported"] == len(_modules()) >= 15
    assert res["jax"] == []


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_jax_import_anywhere_in_the_port():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, (path, bad)


def test_no_wrapper_falls_back_to_plain_version():
    """No ``try`` in the kernel modules has an ``except`` that reaches the
    plain versions (``ref``): a CUDA tensor launches the kernel or raises."""
    for path in sorted((PKG / "kernels").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                names = {n.id for n in ast.walk(handler)
                         if isinstance(n, ast.Name)}
                names |= {n.attr for n in ast.walk(handler)
                          if isinstance(n, ast.Attribute)}
                assert not any("ref" in n for n in names), (path, node.lineno)


def test_chip_smoke_refuses_without_a_card():
    """``chip_smoke.py`` exits non-zero and prints no result line where
    CUDA is missing (here; on a machine with a card it would run)."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
