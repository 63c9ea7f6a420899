"""DeltaForest — key-range-sharded ΔTree (port of ``repro.distributed``;
DESIGN.md §4).

``__all__`` is this package's surface.  Types and the ``router`` /
``splits`` submodules are stable; the free-function entry points are
*deprecated shims* for the handle-based Index API:

    from repro_torch.api import make_index
    ix = make_index("forest", initial=keys, num_shards=4, height=7)

Accessing a deprecated name still works (it resolves to
``repro_torch.distributed.forest``) but emits ``DeprecationWarning``.
Code in this package imports ``repro_torch.distributed.forest`` directly.

Over several ``torch.distributed`` ranks (start the group with
`repro_torch.launch.mesh.start_process_group`), the shards spread over
R of the ranks (`router.span`; `router.forest_mesh` is the "shards"
mesh over them): every rank calls the
same entry points and gets the same results.
"""

import warnings

from repro_torch.distributed import router, splits
from repro_torch.distributed.forest import Forest, ForestConfig

__all__ = [
    "Forest",
    "ForestConfig",
    "alloc_failed",
    "bulk_build",
    "empty",
    "flush",
    "live_items",
    "live_keys",
    "lookup_batch",
    "router",
    "search_batch",
    "shard_tree",
    "splits",
    "successor_jit",
    "update_batch",
]

_DEPRECATED = sorted(set(__all__) - set(globals()))


def __getattr__(name: str):
    if name in _DEPRECATED:
        warnings.warn(
            f"repro_torch.distributed.{name} is deprecated; use the Index "
            f"API (repro_torch.api.make_index('forest', ...)) or import "
            f"repro_torch.distributed.forest.{name} directly",
            DeprecationWarning,
            stacklevel=2,
        )
        from repro_torch.distributed import forest

        return getattr(forest, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
