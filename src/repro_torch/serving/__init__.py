"""Serving package of the port (``repro.serving`` counterpart): the
ΔTree-paged KV cache and the serve engines.

The engine names resolve lazily: ``serving.engine`` pulls in the
scheduler (`repro_torch.serve`), which imports the pager from this
package.  ``ShardedDeltaPager`` keeps the same map on a DeltaForest.
"""

from repro_torch.serving.pager import (
    DeltaPager,
    PagerConfig,
    PagerError,
    make_pager,
)
from repro_torch.serving.sharded_pager import (
    ShardedDeltaPager,
    ShardedPagerConfig,
)

__all__ = [
    "DeltaPager",
    "LockstepServeEngine",
    "PagerConfig",
    "PagerError",
    "ServeEngine",
    "ShardedDeltaPager",
    "ShardedPagerConfig",
    "make_pager",
]

_LAZY = ("ServeEngine", "LockstepServeEngine")


def __getattr__(name: str):
    if name in _LAZY:
        from repro_torch.serving import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
