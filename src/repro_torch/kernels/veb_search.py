"""The vEB walk and scan kernels: CUDA for tensors on the card, plain
PyTorch on the CPU.

Port of ``repro.kernels.veb_search`` (Pallas on a TPU).  The kernels live in
``csrc/veb_walk.cu`` (the walks) and ``csrc/veb_scan.cu`` (the range scan)
and are built at first use (`kernels.build`); the
wrappers here check their inputs, allocate the outputs and launch on the
current stream.  A tensor on the CPU goes to the plain version in
`kernels.ref`; a CUDA tensor goes to the kernel, and a launch the card
refuses raises — there is no fallback from one to the other.

Rows may be int32 (set mode) or int64 (map mode: ``key << bits | payload``
packed values; ordering by packed value equals ordering by key, so the walk
is unchanged).  Unlike the TPU kernels nothing is padded: the arena is read
in place, and any batch size is accepted.

Heights: the plain versions take any height >= 1, the kernels 1 to
``MAX_HEIGHT`` (30: BFS slot indices stay in int32).  Up to
``SMEM_HEIGHT`` (12) a block keeps the vEB position table (and the fused
walk its root ΔNode, the scan its rows) in shared memory; taller ΔNodes,
such as Table 1's UB=N tree (height 22), are read in place through the
table in global memory.

The walks take ``q_tile``, their block size (threads, one a query): one of
``BLOCK_SIZES``, each built into the library; `kernels.ops` resolves it
(`kernels.autotune`).  The scan's lane is a warp and takes none.

Each wrapper counts its kernel launches in a plain integer attribute
(``launches``), incremented only where the kernel is launched.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import pos_table, walk_big  # noqa: F401

MAX_HEIGHT = 30    # veb::kMaxHeight in csrc/veb_common.cuh
SMEM_HEIGHT = 12   # veb::kSmemHeight: taller ΔNodes are read in place
BLOCK_SIZES = (32, 64, 128, 256)   # BlockSizes in csrc/veb_walk.cu
DEFAULT_BLOCK = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_FUSED_ARGS = [_P] * 5 + [_I] * 6 + [_P] * 5 + [_I, _P]
_ROWS_ARGS = [_P] * 4 + [_I] * 4 + [_P] * 4 + [_I, _P]
_SCAN_ARGS = [_P] * 7 + [_I] * 5 + [ctypes.c_longlong] + [_P] * 5


def _suffix(dtype: torch.dtype) -> str:
    if dtype == torch.int32:
        return "i32"
    if dtype == torch.int64:
        return "i64"
    raise TypeError(f"walk kernels take int32 or int64 rows, got {dtype}")


def _kernel_fn(name: str, argtypes, source: str = "veb_walk.cu"):
    from repro_torch.kernels.build import library

    fn = getattr(library(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(name: str, dev: torch.device, **tensors) -> None:
    for arg, x in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name}: {arg} is on {x.device}, expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def _check_height(height: int) -> None:
    if height < 1:
        raise ValueError(f"height must be >= 1, got {height}")


def check_q_tile(tile, origin: str = "q_tile") -> int:
    """A block size the walk kernels were built for, else ValueError
    naming where the size came from."""
    tile = int(tile)
    if tile not in BLOCK_SIZES:
        raise ValueError(f"q_tile must be one of {BLOCK_SIZES} (the walk "
                         f"kernels' block sizes), got {tile} ({origin})")
    return tile


def _check_kernel(name: str, height: int) -> None:
    """The heights the CUDA kernels take beyond the plain versions'."""
    if height > MAX_HEIGHT:
        raise ValueError(f"{name}: the kernels take heights 1..{MAX_HEIGHT} "
                         f"(int32 slot indices), got {height}")


def veb_walk_rows(rows: torch.Tensor, childrows: torch.Tensor,
                  queries: torch.Tensor, *, height: int,
                  q_tile: int = DEFAULT_BLOCK):
    """One full in-ΔNode descent per query.

    rows:      (K, UBp) int32/int64 — each query's current ΔNode row (vEB
               order; UBp >= 2**height - 1)
    childrows: (K, CP)  int32 — matching bottom-slot child ids (-1 none)
    queries:   (K,)     packed, same dtype as rows

    Returns (leaf_val, leaf_b, next_dn, cand): leaf_val/cand in the row
    dtype, leaf_b/next_dn int32, each (K,).  next_dn = -1 when the walk ends
    inside this ΔNode; cand = min left-turn router (``walk_big`` when no
    left turn happened).  ``q_tile`` is the kernel's block size (one of
    ``BLOCK_SIZES``); the plain version on the CPU has none and ignores it.
    """
    _check_height(height)
    if queries.dtype != rows.dtype:
        raise TypeError(f"queries {queries.dtype} != rows {rows.dtype}")
    if rows.device.type == "cpu":
        return ref.ref_veb_walk_rows(rows, childrows, queries, height=height)
    if rows.device.type != "cuda":
        raise ValueError(f"veb_walk_rows: unsupported device {rows.device}")
    _check_kernel("veb_walk_rows", height)
    check_q_tile(q_tile)
    k, ubp = rows.shape
    cp = childrows.shape[1]
    if childrows.dtype != torch.int32 or childrows.shape[0] != k:
        raise ValueError("veb_walk_rows: childrows must be (K, CP) int32")
    if queries.shape != (k,) or ubp < 2 ** height - 1 or cp < 2 ** (height - 1):
        raise ValueError("veb_walk_rows: shapes do not fit the height")
    dev = rows.device
    pos = pos_table(height, dev)
    _check_cuda("veb_walk_rows", dev, rows=rows, childrows=childrows,
                queries=queries, pos=pos)
    leaf_val = torch.empty(k, dtype=rows.dtype, device=dev)
    leaf_b = torch.empty(k, dtype=torch.int32, device=dev)
    next_dn = torch.empty(k, dtype=torch.int32, device=dev)
    cand = torch.empty(k, dtype=rows.dtype, device=dev)
    fn = _kernel_fn(f"veb_walk_rows_{_suffix(rows.dtype)}", _ROWS_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rows.data_ptr(), childrows.data_ptr(), queries.data_ptr(),
                 pos.data_ptr(), k, ubp, cp, height, leaf_val.data_ptr(),
                 leaf_b.data_ptr(), next_dn.data_ptr(), cand.data_ptr(),
                 q_tile, stream)
    veb_walk_rows.launches += 1
    _raise_on("veb_walk_rows", err)
    return leaf_val, leaf_b, next_dn, cand


veb_walk_rows.launches = 0


def veb_walk_fused(value: torch.Tensor, child: torch.Tensor,
                   roots: torch.Tensor, queries: torch.Tensor, *,
                   height: int, max_rounds: int,
                   q_tile: int = DEFAULT_BLOCK):
    """All walk rounds in one launch.

    value:   (M, UB) arena rows, int32/int64 (read in place)
    child:   (M, leaf_cap) int32 bottom-slot child ids (-1 none)
    roots:   (K,) int32 per-query frontier seeds
    queries: (K,) packed, same dtype as value

    Returns the `ops.delta_walk` 5-tuple (leaf_val, leaf_b, final_dn, hops,
    cand), each (K,).  Sentinel queries (``walk_big``) are born resolved;
    a lane stops after ``max_rounds`` rounds whether or not it resolved.
    ``q_tile`` is the kernel's block size (one of ``BLOCK_SIZES``; the
    lanes of a block share its first lane's staged root); the plain
    version on the CPU has none and ignores it.
    """
    _check_height(height)
    if queries.dtype != value.dtype:
        raise TypeError(f"queries {queries.dtype} != value {value.dtype}")
    if value.device.type == "cpu":
        return ref.ref_delta_walk_fused(value, child, roots, queries,
                                        height=height, max_rounds=max_rounds)
    if value.device.type != "cuda":
        raise ValueError(f"veb_walk_fused: unsupported device {value.device}")
    _check_kernel("veb_walk_fused", height)
    check_q_tile(q_tile)
    m, ub = value.shape
    lc = child.shape[1]
    k = queries.shape[0]
    if ub != 2 ** height - 1 or lc != 2 ** (height - 1) or child.shape[0] != m:
        raise ValueError("veb_walk_fused: arena shapes do not fit the height")
    if child.dtype != torch.int32 or roots.dtype != torch.int32:
        raise ValueError("veb_walk_fused: child and roots must be int32")
    if roots.shape != (k,) or queries.shape != (k,):
        raise ValueError("veb_walk_fused: roots and queries must be (K,)")
    dev = value.device
    pos = pos_table(height, dev)
    _check_cuda("veb_walk_fused", dev, value=value, child=child, roots=roots,
                queries=queries, pos=pos)
    leaf_val = torch.empty(k, dtype=value.dtype, device=dev)
    leaf_b = torch.empty(k, dtype=torch.int32, device=dev)
    final_dn = torch.empty(k, dtype=torch.int32, device=dev)
    hops = torch.empty(k, dtype=torch.int32, device=dev)
    cand = torch.empty(k, dtype=value.dtype, device=dev)
    fn = _kernel_fn(f"veb_walk_fused_{_suffix(value.dtype)}", _FUSED_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(value.data_ptr(), child.data_ptr(), roots.data_ptr(),
                 queries.data_ptr(), pos.data_ptr(), k, m, ub, lc, height,
                 int(max_rounds), leaf_val.data_ptr(), leaf_b.data_ptr(),
                 final_dn.data_ptr(), hops.data_ptr(), cand.data_ptr(),
                 q_tile, stream)
    veb_walk_fused.launches += 1
    _raise_on("veb_walk_fused", err)
    return leaf_val, leaf_b, final_dn, hops, cand


veb_walk_fused.launches = 0


def veb_scan_fused(value: torch.Tensor, mark: torch.Tensor,
                   child: torch.Tensor, roots: torch.Tensor,
                   starts: torch.Tensor, his: torch.Tensor, *, height: int,
                   max_out: int, pmask: int, max_rounds: int):
    """All passes of the emit-cursor range scan in one launch.

    value:  (M, UB) arena rows, int32/int64 (read in place)
    mark:   (M, UB) bool deletion marks
    child:  (M, leaf_cap) int32 bottom-slot child ids (-1 none)
    roots:  (K,) int32 per-lane seeds
    starts/his: (K,) packed ``qpack`` bounds in the value dtype (start
            exclusive, hi inclusive in key space); a start equal to
            ``walk_big`` marks a lane that is born done

    Returns (out (K, max_out) packed ascending with ``walk_big`` padding,
    n (K,) int32, hops (K,) int32, more (K,) bool): the contract of
    `ref.ref_delta_scan_fused`, which documents the passes.  The kernel
    runs a lane on a warp, four lanes a block (fewer where tall rows fill
    the shared memory), and walks a pass only from where its path leaves
    the last one; ``hops`` still counts every round the plain version
    runs.
    """
    _check_height(height)
    if starts.dtype != value.dtype or his.dtype != value.dtype:
        raise TypeError(f"starts {starts.dtype} / his {his.dtype} != "
                        f"value {value.dtype}")
    if max_out < 1:
        raise ValueError(f"veb_scan_fused: max_out must be >= 1, got {max_out}")
    if value.device.type == "cpu":
        return ref.ref_delta_scan_fused(value, mark, child, roots, starts, his,
                                        height=height, max_rounds=max_rounds,
                                        max_out=max_out, pmask=pmask)
    if value.device.type != "cuda":
        raise ValueError(f"veb_scan_fused: unsupported device {value.device}")
    _check_kernel("veb_scan_fused", height)
    m, ub = value.shape
    lc = child.shape[1]
    k = starts.shape[0]
    if ub != 2 ** height - 1 or lc != 2 ** (height - 1) or child.shape[0] != m:
        raise ValueError("veb_scan_fused: arena shapes do not fit the height")
    if mark.dtype != torch.bool or mark.shape != value.shape:
        raise ValueError("veb_scan_fused: mark must be bool, shaped as value")
    if child.dtype != torch.int32 or roots.dtype != torch.int32:
        raise ValueError("veb_scan_fused: child and roots must be int32")
    if roots.shape != (k,) or starts.shape != (k,) or his.shape != (k,):
        raise ValueError("veb_scan_fused: roots, starts and his must be (K,)")
    dev = value.device
    pos = pos_table(height, dev)
    _check_cuda("veb_scan_fused", dev, value=value, mark=mark, child=child,
                roots=roots, starts=starts, his=his, pos=pos)
    out = torch.empty((k, max_out), dtype=value.dtype, device=dev)
    n = torch.empty(k, dtype=torch.int32, device=dev)
    hops = torch.empty(k, dtype=torch.int32, device=dev)
    more = torch.empty(k, dtype=torch.bool, device=dev)
    fn = _kernel_fn(f"veb_scan_fused_{_suffix(value.dtype)}", _SCAN_ARGS,
                    "veb_scan.cu")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(value.data_ptr(), mark.data_ptr(), child.data_ptr(),
                 roots.data_ptr(), starts.data_ptr(), his.data_ptr(),
                 pos.data_ptr(), k, m, height, int(max_out),
                 int(max_rounds), int(pmask), out.data_ptr(), n.data_ptr(),
                 hops.data_ptr(), more.data_ptr(), stream)
    veb_scan_fused.launches += 1
    _raise_on("veb_scan_fused", err)
    return out, n, hops, more


veb_scan_fused.launches = 0


def fuse_arenas(value: torch.Tensor, child: torch.Tensor, root: torch.Tensor):
    """Concatenate stacked shard arenas into one base-offset arena view.

    value (S, M, UB) / child (S, M, leaf_cap) / root (S,) are S independent
    arenas whose ΔNode ids are arena-local.  The fused view is one
    (S*M, ...) arena in which shard ``s``'s ids shift by ``s*M``: the base
    offset is applied to child links and roots once, here, never per walk
    round, so a walk with per-query roots drives one frontier across every
    shard.  Child links of -1 (none) are kept; a walk seeded at shard
    ``s``'s fused root only ever reaches shard ``s``'s rows (links never
    cross arenas), so its results equal a walk of that shard alone.

    ``value`` comes back as a reshape of the stacked tensor (no copy, so
    later in-place writes to the arena show through); ``child`` is a new
    tensor and goes stale when the arena's links change.  Returns
    (fused_value (S*M, UB), fused_child (S*M, leaf_cap), fused_roots (S,)
    int32).
    """
    s, m = value.shape[0], value.shape[1]
    if s * m > 2**31 - 1:
        raise ValueError(f"fuse_arenas: {s} x {m} ΔNodes overflow int32 ids")
    base = torch.arange(s, dtype=torch.int32, device=value.device) * m
    child = torch.where(child >= 0, child + base[:, None, None], child)
    return (value.reshape((s * m,) + value.shape[2:]),
            child.reshape((s * m,) + child.shape[2:]),
            root.to(torch.int32) + base)
