"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix, and the metrics.  Every part is a file of
its own under ``portbench/``:

- a configuration: the ``file`` its ``configs`` entry names (JSON);
- a traffic mix: ``portbench/traffic/<traffic>.json``;
- a metric: ``portbench/metrics/<name>.py``, a reader with
  ``read(run, name)`` (and, optionally, ``capture(ctx)``, called in a
  traced run once its profiled stretch has closed).

So a later change adds a cell, a mix or a metric as new files and new
entries, and edits no file that is here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]     # the checkout


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def by_name(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r}")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = by_name(bench["configs"], name, "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def load_traffic(name: str, root: Path = ROOT) -> dict:
    path = Path(root) / "portbench" / "traffic" / f"{name}.json"
    return json.loads(path.read_text())


def metric_file(name: str, root: Path = ROOT) -> Path:
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}")
    return path


_MODULES: dict = {}


def metric_module(name: str, root: Path = ROOT):
    path = metric_file(name, root)
    if path not in _MODULES:
        mod_name = "portbench_metric_" + "".join(
            c if c.isalnum() else "_" for c in path.stem)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones (an entry without ``workloads``
    holds for every cell)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]
