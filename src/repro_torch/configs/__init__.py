"""Architecture configs of the port (``repro.configs`` counterpart).

Each module defines ``CONFIG`` (the full published config) and ``SMOKE`` (a
reduced config of the same family for CPU tests), as in the JAX package.
Only the architectures the port runs are here; ``get_config`` of any other
raises and names ROADMAP.md.
"""

from __future__ import annotations

import importlib

ARCH_IDS = ["granite_8b"]

# accept the dashed public id too
ALIASES = {"granite-8b": "granite_8b"}


def _module(name: str):
    name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported to repro_torch (see "
            f"ROADMAP.md, Queue 1); ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).SMOKE
