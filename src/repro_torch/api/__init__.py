"""repro_torch.api — the handle-based Index API (port of ``repro.api``).

    ix = make_index("deltatree", initial=keys, engine="lockstep")   # on cuda
    found, hops = ix.search(queries)
    ix, results = ix.insert_delete(OpBatch.mixed(kinds, keys))
    found, succ = ix.successor(queries)
    page = ix.range_scan(lo, hi, max_items=128)        # ScanResult (+ cursor)
    keys, pays, n, hops, more = ix.successor_k(queries, 16)

``make_index("forest", num_shards=S, ...)`` gives the same handle over a
key-range-sharded DeltaForest.  Pass ``device="cpu"`` to run on the CPU.
"""

from repro_torch.api.index import (
    BackendSpec,
    Capability,
    CapabilityError,
    Index,
    IndexSpec,
)
from repro_torch.api.opbatch import OP_DELETE, OP_INSERT, OP_SEARCH, OpBatch
from repro_torch.core.scan import ScanCursor, ScanResult
from repro_torch.api.registry import (
    available_backends,
    get_backend,
    make_index,
    register_backend,
    supported_engines,
    supported_maintenance,
)
from repro_torch.api import backends as _backends  # noqa: F401  (registers built-ins)

__all__ = [
    "BackendSpec",
    "Capability",
    "CapabilityError",
    "Index",
    "IndexSpec",
    "OpBatch",
    "OP_SEARCH",
    "OP_INSERT",
    "OP_DELETE",
    "ScanCursor",
    "ScanResult",
    "available_backends",
    "get_backend",
    "make_index",
    "register_backend",
    "supported_engines",
    "supported_maintenance",
]
