"""The Index handle: one method-style surface over every backend (port of
``repro.api.index``).

An ``Index`` is (static spec, state): ``spec`` holds the registered
``BackendSpec`` (a table of functions) and the backend's config; ``state``
is the backend's tensors (a ``DeltaTree``, a ``Forest`` of stacked ones,
or a baseline's state).  Methods delegate through the spec;
``capability`` says which ones a backend supports
(``CapabilityError`` otherwise).  Reads take keys as a tensor, a numpy
array or a list and return tensors on the index's device.

Updates run in place on the state's tensors: ``insert_delete`` returns a
handle over the same (updated) state, and the old handle must not be read
as a snapshot of the pre-update set.  Rebind as in the JAX package:
``ix, res = ix.insert_delete(batch)``.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable

from repro_torch.api.opbatch import OpBatch

if TYPE_CHECKING:
    from repro_torch.core.scan import ScanCursor, ScanResult


def cfg_attr(cfg, name: str, default=None):
    """A config knob on ``cfg`` or on its nested ``cfg.tree`` (the forest
    config wraps a TreeConfig): the one rule for ``engine`` /
    ``maintenance`` style knobs."""
    v = getattr(cfg, name, None)
    if v is None:
        v = getattr(getattr(cfg, "tree", None), name, None)
    return default if v is None else v


@dataclasses.dataclass(frozen=True)
class Capability:
    """What an Index backend supports (fields as in the JAX package)."""

    map_mode: bool = False    # key -> payload lookups (else set semantics)
    successor: bool = False   # ordered successor queries
    sharded: bool = False     # state fans out over several devices
    updates: bool = True      # insert_delete supported at all
    deferred_maintenance: bool = False  # non-eager policies + flush()
    fused_forest: bool = False  # sharded reads share one fused frontier
    range_scan: bool = False  # ordered range pages (range_scan + cursors)
    successor_k: bool = False  # bulk k-successor reads (successor_k)


class CapabilityError(NotImplementedError):
    """Raised when an Index method is not in the backend's Capability."""


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Registry entry: a table of functions over (cfg, state).

    Required hooks: ``make``, ``capability``, ``search``, ``update``,
    ``live_items``, ``size``.  Optional hooks may be None and are gated by
    ``capability(cfg)``: ``lookup`` (map_mode), ``successor``, ``scan``
    (range_scan), ``successor_k``.  ``touch`` (ideal-cache touch traces,
    Table 1), ``alloc_failed`` (sticky arena-exhaustion flag) and
    ``flush`` are optional.  ``engines`` lists the SearchEngine names the
    backend's read path can run under (``"*"``: every engine registered in
    ``repro_torch.core.engine``); ``maintenance`` the policy kinds it
    accepts.
    """

    name: str
    make: Callable[..., tuple[Any, Any]]        # (initial, payloads, **kw)
    capability: Callable[[Any], Capability]     # cfg -> Capability
    search: Callable[..., Any]                  # (cfg, state, keys) -> (found, hops)
    update: Callable[..., Any]                  # (cfg, state, OpBatch) -> (state, results, stats)
    live_items: Callable[..., Any]              # (cfg, state) -> [(key, payload)]
    size: Callable[..., int]                    # (cfg, state) -> int
    lookup: Callable[..., Any] | None = None    # (cfg, state, keys) -> (found, payload, hops)
    successor: Callable[..., Any] | None = None  # (cfg, state, keys) -> (found, succ)
    # (cfg, state, starts[K], his[K], max_items) -> (keys (K, max_items),
    # payloads, n, hops, more): inclusive-hi ordered pages per lane,
    # rows zero-padded past n
    scan: Callable[..., Any] | None = None
    # (cfg, state, keys[K], k) -> the same 5-tuple: the k smallest keys
    # strictly greater than each query
    successor_k: Callable[..., Any] | None = None
    # (cfg, state) -> (key -> [flat element indices a search reads])
    touch: Callable[..., Any] | None = None
    alloc_failed: Callable[..., bool] | None = None  # (cfg, state) -> bool
    flush: Callable[..., Any] | None = None     # (cfg, state) -> (state, stats)
    engines: tuple[str, ...] = ("scalar",)      # selectable read engines
    maintenance: tuple[str, ...] = ("eager",)   # selectable policy kinds


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Static half of an Index."""

    backend: BackendSpec
    cfg: Any


class Index:
    """Handle over one backend instance."""

    __slots__ = ("spec", "state")

    def __init__(self, spec: IndexSpec, state: Any):
        object.__setattr__(self, "spec", spec)
        object.__setattr__(self, "state", state)

    def __setattr__(self, name, value):
        raise AttributeError(
            "Index is immutable; rebind the handle returned by insert_delete")

    def __repr__(self):
        return (f"Index(backend={self.spec.backend.name!r}, "
                f"cfg={self.spec.cfg!r})")

    # ---- static introspection ----

    @property
    def backend(self) -> str:
        return self.spec.backend.name

    @property
    def cfg(self) -> Any:
        return self.spec.cfg

    @property
    def capability(self) -> Capability:
        return self.spec.backend.capability(self.spec.cfg)

    @property
    def engine(self) -> str:
        """Active SearchEngine name."""
        return cfg_attr(self.spec.cfg, "engine") or "scalar"

    @property
    def maintenance(self) -> str:
        """Active maintenance policy string."""
        return cfg_attr(self.spec.cfg, "maintenance") or "eager"

    @property
    def collect_stats(self) -> bool:
        """True when this handle's hop-bearing reads return a trailing
        `repro_torch.obs.stats.ReadStats` (``TreeConfig.collect_stats``;
        always False for backends without the knob)."""
        return bool(cfg_attr(self.spec.cfg, "collect_stats", False))

    def _require(self, flag: str, hook) -> None:
        if not getattr(self.capability, flag) or hook is None:
            raise CapabilityError(
                f"backend {self.backend!r} does not support {flag!r} "
                f"(capability: {self.capability})")

    # ---- wait-free reads ----

    def search(self, keys):
        """Membership on the current state. Returns (found[K], hops[K]),
        plus a trailing ``ReadStats`` when ``self.collect_stats``."""
        return self.spec.backend.search(self.spec.cfg, self.state, keys)

    def lookup(self, keys):
        """Map-mode read. Returns (found[K], payload[K], hops[K]), plus a
        trailing ``ReadStats`` when ``self.collect_stats``."""
        self._require("map_mode", self.spec.backend.lookup)
        return self.spec.backend.lookup(self.spec.cfg, self.state, keys)

    def successor(self, keys):
        """Smallest stored key strictly greater. Returns (found[K], succ[K])."""
        self._require("successor", self.spec.backend.successor)
        return self.spec.backend.successor(self.spec.cfg, self.state, keys)

    def range_scan(self, lo: int, hi: int, *, max_items: int = 128,
                   cursor: "ScanCursor | None" = None) -> "ScanResult":
        """One ordered page of the live set: up to ``max_items`` (key,
        payload) rows with ``lo <= key <= hi``, ascending, as numpy arrays.
        When the page fills before the range is exhausted, ``result.more``
        is True and ``result.cursor`` resumes the next page:
        ``ix.range_scan(lo, hi, cursor=result.cursor)`` (the cursor's bounds
        override ``lo``/``hi``).  Each page reads the *current* state —
        updates between pages are seen from their page boundary onward."""
        from repro_torch.core import layout
        from repro_torch.core.scan import ScanCursor, ScanResult

        self._require("range_scan", self.spec.backend.scan)
        if cursor is not None:
            lo, hi = cursor.last_key + 1, cursor.hi
        hi = min(int(hi), layout.KEY_MAX)
        ks, ps, n, _, more = self.spec.backend.scan(
            self.spec.cfg, self.state, [max(int(lo) - 1, 0)], [hi],
            max_items)
        count = int(n[0])
        truncated = bool(more[0]) and count > 0
        keys = ks[0].cpu().numpy()[:count]
        pays = ps[0].cpu().numpy()[:count]
        cur = (ScanCursor(last_key=int(keys[-1]), hi=hi)
               if truncated else None)
        return ScanResult(keys=keys, payloads=pays, more=truncated,
                          cursor=cur)

    def successor_k(self, keys, k: int):
        """Bulk ordered read: per query, the ``k`` smallest live keys
        strictly greater.  Returns (keys (K, k) int32 ascending rows,
        payloads (K, k) int32, n (K,) int32, hops (K,) int32, more (K,)
        bool) — rows are zero-padded past ``n``; ``more`` marks queries with
        further successors beyond the ``k`` returned."""
        self._require("successor_k", self.spec.backend.successor_k)
        return self.spec.backend.successor_k(
            self.spec.cfg, self.state, keys, k)

    # ---- updates ----

    def insert_delete(self, batch: OpBatch):
        """Apply one OpBatch in batch order. Returns (new Index, results[K]).

        OP_SEARCH rows are no-ops with result False.  The state is updated
        in place (`update` is the same call keeping the MaintenanceStats).
        """
        ix, results, _ = self.update(batch)
        return ix, results

    def update(self, batch: OpBatch):
        """`insert_delete` returning telemetry: (new Index, results[K],
        MaintenanceStats | None); None for backends without a maintenance
        scheduler (the baselines)."""
        self._require("updates", self.spec.backend.update)
        state, results, stats = self.spec.backend.update(
            self.spec.cfg, self.state, batch)
        return Index(self.spec, state), results, stats

    def flush(self):
        """Drain pending maintenance to fixpoint.  Returns (new Index,
        MaintenanceStats | None)."""
        if self.spec.backend.flush is None:
            return self, None
        state, stats = self.spec.backend.flush(self.spec.cfg, self.state)
        return Index(self.spec, state), stats

    # ---- host-side diagnostics ----

    def size(self) -> int:
        """Number of live keys (host-side)."""
        return int(self.spec.backend.size(self.spec.cfg, self.state))

    def live_items(self) -> list[tuple[int, int]]:
        """All live (key, payload) pairs in ascending key order (host-side,
        for tests)."""
        return list(self.spec.backend.live_items(self.spec.cfg, self.state))

    def touch_fn(self):
        """Host touch-trace function (ideal-cache transfer counting) or
        None."""
        if self.spec.backend.touch is None:
            return None
        return self.spec.backend.touch(self.spec.cfg, self.state)

    def alloc_failed(self) -> bool:
        """Sticky arena-exhaustion flag (False for unbounded backends)."""
        if self.spec.backend.alloc_failed is None:
            return False
        return bool(self.spec.backend.alloc_failed(self.spec.cfg, self.state))
