"""ΔTree core (port of ``repro.core``): the vEB layout tables, the tree
itself, its read engines and the set/map oracles.

``__all__`` below is this package's surface, the same names as
``repro.core``'s.  Types, constants and the ``layout`` / ``engine``
submodules are stable; the free-function entry points are *deprecated
shims* for the handle-based Index API:

    from repro_torch.api import make_index
    ix = make_index("deltatree", initial=keys, height=7)

Accessing a deprecated name still works (it resolves to
``repro_torch.core.deltatree``) but emits ``DeprecationWarning``.  Code in
this package imports ``repro_torch.core.deltatree`` directly.
"""

import warnings

from repro_torch.core import layout
from repro_torch.core.deltatree import (
    OP_DELETE,
    OP_INSERT,
    OP_SEARCH,
    DeltaTree,
    TreeConfig,
)
from repro_torch.core import engine
from repro_torch.core.engine import (
    ForestBatch,
    SearchEngine,
    available_engines,
    get_engine,
    register_engine,
)

__all__ = [
    "layout",
    "engine",
    "ForestBatch",
    "SearchEngine",
    "available_engines",
    "get_engine",
    "register_engine",
    "TreeConfig",
    "DeltaTree",
    "empty",
    "bulk_build",
    "live_keys",
    "search_batch",
    "search_one",
    "successor_batch",
    "successor_jit",
    "successor_one",
    "lookup_batch",
    "lookup_jit",
    "live_items",
    "search_jit",
    "update_batch",
    "update_batch_impl",
    "flush",
    "flush_impl",
    "OP_SEARCH",
    "OP_INSERT",
    "OP_DELETE",
]

# names not bound above resolve lazily through __getattr__ with a warning
_DEPRECATED = sorted(set(__all__) - set(globals()))


def __getattr__(name: str):
    if name in _DEPRECATED:
        warnings.warn(
            f"repro_torch.core.{name} is deprecated; use the Index API "
            f"(repro_torch.api.make_index('deltatree', ...)) or import "
            f"repro_torch.core.deltatree.{name} directly",
            DeprecationWarning,
            stacklevel=2,
        )
        from repro_torch.core import deltatree

        return getattr(deltatree, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
