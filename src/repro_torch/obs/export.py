"""Metrics export: point-in-time snapshots of the stats tuples (port of
``repro.obs.export``).

Every stats class in `repro_torch.obs.stats` renders itself host-side
(``asdict``).  This module composes those dicts into one named snapshot and
serializes it two ways:

- ``to_prometheus(snap)``: Prometheus text exposition (version 0.0.4) —
  scalars become gauges, list-valued counters (histogram bins, per-shard
  lanes, round occupancy) become labelled series with an ``index`` label.
- ``to_json(snap)``: the same snapshot as a JSON document.

``ServeScheduler.metrics()`` is the live producer.  Values may be Python
numbers, numpy values or tensors (0-d or 1-d); rendering reads nothing
beyond the ``asdict`` host reads the stats classes already do.
"""

from __future__ import annotations

import json
import numbers

import numpy as np

__all__ = ["snapshot", "to_prometheus", "to_json"]


def _plain(v):
    """Coerce one metric value to a JSON/Prometheus-safe plain type."""
    if hasattr(v, "detach"):                 # a tensor
        v = v.detach().cpu().numpy()
    if isinstance(v, (bool, np.bool_)):
        return int(v)
    if isinstance(v, numbers.Number):
        return v.item() if hasattr(v, "item") else v
    if isinstance(v, (list, tuple, np.ndarray)):
        if isinstance(v, np.ndarray) and v.ndim == 0:
            return _plain(v.item())
        return [_plain(x) for x in np.asarray(v).tolist()]
    if hasattr(v, "item"):
        return v.item()
    return v


def snapshot(**groups) -> dict:
    """Compose named stats into one plain-python snapshot.

    Each keyword is a group name mapping to a stats tuple (anything with
    ``asdict``), a plain dict of numbers, or ``None`` (dropped) — e.g.
    ``snapshot(search=rs.search, transfers=rs.transfers,
    serve=sched.obs, maintenance=worker.stats())``.
    """
    out = {}
    for name, obj in groups.items():
        if obj is None:
            continue
        d = obj.asdict() if hasattr(obj, "asdict") else dict(obj)
        out[name] = {k: _plain(v) for k, v in d.items()}
    return out


def to_prometheus(snap: dict, prefix: str = "repro") -> str:
    """Render a ``snapshot`` as Prometheus text exposition."""
    lines = []
    for group in sorted(snap):
        for key in snap[group]:
            v = snap[group][key]
            name = f"{prefix}_{group}_{key}"
            lines.append(f"# TYPE {name} gauge")
            if isinstance(v, list):
                lines.extend(
                    f'{name}{{index="{i}"}} {_num(x)}'
                    for i, x in enumerate(v))
            else:
                lines.append(f"{name} {_num(v)}")
    return "\n".join(lines) + "\n" if lines else ""


def _num(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, numbers.Number):
        return str(v)
    raise TypeError(f"non-numeric metric value {v!r}")


def to_json(snap: dict, **dump_kw) -> str:
    dump_kw.setdefault("sort_keys", True)
    return json.dumps(snap, **dump_kw)
