"""q_tile autotuner for the walk kernels (port of ``repro.kernels.autotune``):
sweep the block size per tree height and keep the winners in a
height→size table that ``ops.default_q_tile`` consults.

On the card ``q_tile`` is the walk kernels' block size: the threads (one
a query) of a block, which share the root ΔNode the fused kernel stages
(``csrc/veb_walk.cu``, built for each of ``CANDIDATES``).  Resolution
order for a ``q_tile=None`` walk (``ops.default_q_tile``):

1. ``REPRO_TORCH_QTILE``, a process-wide pin;
2. the ``REPRO_TORCH_AUTOTUNE`` cache file, a JSON table written by
   `save_cache` from `sweep_height` on the card at hand (keys
   ``"<height>/<compiled|interpret>/<bits>"``, values sizes; ``compiled``
   on the card, ``interpret`` for the plain versions on the CPU, which
   ignore the size);
3. the committed ``BAKED`` table below;
4. 64.

The JAX package's variables (``REPRO_PALLAS_AUTOTUNE``,
``REPRO_PALLAS_QTILE``) and its table are not read: their entries are
XLA / TPU query tiles (128-1024) and mean nothing to a CUDA block.
"""

from __future__ import annotations

import json
import os

ENV_CACHE = "REPRO_TORCH_AUTOTUNE"

CANDIDATES = (32, 64, 128, 256)

# Committed winners: (height, compiled, bits) -> block size, only from
# sweep_height on an H100 and only where a size beats 64 by more than the
# spread of repeated reads.  Empty: no size did (PERF.md §6).
BAKED: dict[tuple[int, bool, int], int] = {}

# clock cycles of the sleep ahead of a timed run, per launch in it: more
# than the host takes to queue a launch (~0.06 ms on an H100's host)
_SLEEP_CYCLES_A_LAUNCH = 400_000


def cache_path() -> str | None:
    """The ``REPRO_TORCH_AUTOTUNE`` cache file path (None = no cache)."""
    p = os.environ.get(ENV_CACHE, "").strip()
    return p or None


def _key(height: int, compiled: bool, bits: int) -> str:
    return f"{height}/{'compiled' if compiled else 'interpret'}/{bits}"


# path -> (the file's (inode, size, mtime) when read, its table): a walk
# resolves its size from the cache, so the file is parsed once a change
_READ: dict[str, tuple[tuple[int, int, int], dict[str, int]]] = {}


def _table(path: str | None) -> dict[str, int]:
    """The cache file's table, read again only when the file changed
    (the memo is shared: do not mutate the result)."""
    path = path or cache_path()
    if not path:
        return {}
    try:
        st = os.stat(path)
    except OSError:
        return {}
    stamp = (st.st_ino, st.st_size, st.st_mtime_ns)
    hit = _READ.get(path)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    try:
        with open(path) as f:
            raw = json.load(f)
        table = {str(k): int(v) for k, v in raw.items()}
    except (json.JSONDecodeError, OSError, TypeError, ValueError):
        table = {}
    _READ[path] = (stamp, table)
    return table


def load_cache(path: str | None = None) -> dict[str, int]:
    """Read the autotune cache (missing/corrupt file = empty table: the
    autotuner must never make a walk fail)."""
    return dict(_table(path))


def save_cache(table: dict[str, int], path: str | None = None) -> str | None:
    """Merge ``table`` into the cache file (existing keys updated).
    Returns the path written, or None when no cache is configured."""
    path = path or cache_path()
    if not path:
        return None
    merged = load_cache(path)
    merged.update({str(k): int(v) for k, v in table.items()})
    with open(path, "w") as f:
        json.dump(merged, f, indent=1, sort_keys=True)
    _READ.pop(path, None)   # a rewrite within one clock tick keeps its mtime
    return path


def best_q_tile(height: int, *, compiled: bool, bits: int = 32
                ) -> int | None:
    """Autotuned block size for ``height`` under the given mode, or None
    when neither the cache nor the baked table knows it."""
    hit = _table(None).get(_key(height, compiled, bits))
    if hit is not None:
        return hit
    return BAKED.get((height, compiled, bits))


def sweep_height(height: int, *, batch: int = 1024, n_keys: int = 50_000,
                 repeats: int = 3, iters: int = 10,
                 candidates: tuple[int, ...] = CANDIDATES,
                 payload_bits: int = 0, seed: int = 0, device="cuda"):
    """Time `ops.delta_walk` (the fused kernel) per candidate block size on
    a bulk-built tree, on the card.

    The tree and queries follow the JAX package's sweep: ``n_keys`` draws
    in [1, 4 n_keys) from ``seed``, ``max_dnodes = max(256, 6 n_keys /
    2**(height-1))``, ``batch`` queries from the same range.  Returns
    ``(best_size, {size: seconds-per-launch})``: per size a warm-up launch
    off the clock, then ``repeats`` runs of ``iters`` back-to-back
    launches between CUDA events, the best run kept.  A run's launches
    are queued behind a sleep kernel issued before its start event, so
    the window holds the card's work and not the host's (a call's host
    work outlasts the kernel at this batch); the tree stays in L2 from
    one launch to the next.  Raises on the CPU, where no block size
    reaches a kernel.
    """
    import numpy as np
    import torch

    from repro_torch.core import deltatree as DT
    from repro_torch.kernels import ops as OPS

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(
            f"sweep_height times the CUDA walk kernel; on {device} the plain "
            "version runs and no block size reaches a kernel")
    rng = np.random.default_rng(seed)
    cfg = DT.TreeConfig(height=height, payload_bits=payload_bits,
                        max_dnodes=max(256, 6 * n_keys // 2 ** (height - 1)))
    vals = np.unique(rng.integers(1, 4 * n_keys, n_keys).astype(np.int32))
    t = DT.bulk_build(cfg, vals, device=device)
    q = cfg.qpack(torch.as_tensor(
        rng.integers(1, 4 * n_keys, batch).astype(np.int32), device=device))

    timings: dict[int, float] = {}
    for tile in candidates:
        def walk():
            return OPS.delta_walk(t.value, t.child, t.root, q, height=height,
                                  q_tile=tile)

        walk()
        torch.cuda.synchronize(device)   # the launch's set-up off the clock
        best = float("inf")
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SLEEP_CYCLES_A_LAUNCH * iters)
            start.record()
            for _ in range(iters):
                walk()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / iters)
        timings[tile] = best
    best_tile = min(timings, key=timings.get)
    return best_tile, timings
