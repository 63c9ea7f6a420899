"""ΔTree-paged decode attention: CUDA for tensors on the card, plain PyTorch
on the CPU (port of ``repro.kernels.delta_paged_attention``, the serve
path's kernel).

The pager resolves each sequence's (seq, logical block) -> page mapping
with a wait-free ΔTree lookup into a block table; this kernel reads only
the pages a sequence owns.  The CUDA kernel lives in
``csrc/paged_attention.cu`` (built at first use, `kernels.build`): a
split-K kernel over chunks of each sequence's pages, then a merge of the
chunks' partial softmax states.  The wrapper checks its inputs, plans the
split from the shapes and the card's SM count (`split_plan`; it never
reads a length on the host), allocates the output and the float32
scratch, and launches on the current stream.  A tensor on the CPU goes to the plain version
`kernels.ref.ref_paged_decode_attention`; a CUDA tensor goes to the kernel,
and a launch the card refuses raises — there is no fallback from one to the
other.  ``paged_decode_attention.launches`` counts calls that launched the kernel
(one a call, whether the plan adds the merge or not): an empty batch
launches nothing, and a refused launch is not counted.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P] * 5 + [_I] * 9 + [ctypes.c_float, _P, _P, _P]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# csrc/paged_attention.cu's constants
WARPS = 4             # warps a block, each with its own ring of pages
STAGES = 3            # pages a warp's ring holds
MAX_G = 8             # query heads a block: a larger group splits (`subgroups`)
SMEM_LIMIT = 232448   # dynamic shared memory a block may opt in to (227 KB)
# the split plan: blocks to aim for per SM, and pages each warp should get
BLOCKS_PER_SM = 2
MIN_PAGES_PER_WARP = 2


def split_plan(b: int, kvh: int, maxp: int, sm_count: int) -> tuple[int, int]:
    """(splits, pages_per_split) for a (B, KVH, MAXP) call on a card with
    ``sm_count`` SMs: split each sequence's MAXP logical pages into chunks
    so that the grid holds about ``BLOCKS_PER_SM`` blocks an SM, but give
    no chunk fewer than ``MIN_PAGES_PER_WARP`` pages a warp.  A function of
    shapes only, never of the lengths, so planning costs no host sync.
    Chunk s covers pages [s * pps, (s + 1) * pps); splits * pps >= MAXP and
    no chunk is empty of logical pages."""
    maxp = max(maxp, 1)
    want = -(-BLOCKS_PER_SM * sm_count // max(b * kvh, 1))
    most = max(1, maxp // (WARPS * MIN_PAGES_PER_WARP))
    splits = max(1, min(want, most))
    pps = -(-maxp // splits)
    return -(-maxp // pps), pps


def subgroups(g: int) -> tuple[int, int]:
    """(sub-groups, heads in each) of a group of ``g`` query heads a KV
    head: at most ``MAX_G`` heads a block, as even as possible (G = 12:
    two blocks of 6).  The kernel computes the same plan."""
    n = -(-g // MAX_G)
    return n, -(-g // n)


def smem_bytes(ps: int, d: int, g: int, elt: int) -> int:
    """The kernel's dynamic shared memory a block: each warp's ring of
    ``STAGES`` K/V pages of one head plus its scores and rescale factors
    (16-byte padded), then the area where the warps merge their states;
    a sub-group's heads (`subgroups`) round up to a power of two."""
    gp = 1 << (subgroups(g)[1] - 1).bit_length()
    warp = STAGES * 2 * ps * d * elt + -(-(ps * gp + gp) * 4 // 16) * 16
    return WARPS * warp + WARPS * (2 * gp + gp * d) * 4


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel_fn(dtype: torch.dtype):
    from repro_torch.kernels.build import library

    fn = getattr(library("paged_attention.cu"),
                 f"paged_decode_attention_{_SUFFIX[dtype]}")
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, block_tables, seq_lens) -> None:
    if q.ndim != 3 or k_pages.ndim != 4:
        raise ValueError("paged_decode_attention: q must be (B, QH, D) and "
                         "k/v_pages (NP, PS, KVH, D)")
    b, qh, d = q.shape
    kvh = k_pages.shape[2]
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != d:
        raise ValueError("paged_decode_attention: k/v_pages shapes differ or "
                         "do not match q's head dim")
    if qh % kvh:
        raise ValueError(f"paged_decode_attention: {qh} query heads do not "
                         f"group over {kvh} KV heads")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_decode_attention: q, k_pages and v_pages must "
                        "share one dtype")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tables and seq_lens "
                        "must be int32")
    if block_tables.ndim != 2 or block_tables.shape[0] != b \
            or seq_lens.shape != (b,):
        raise ValueError("paged_decode_attention: block_tables must be "
                         "(B, MAXP) and seq_lens (B,)")
    if q.dtype not in _SUFFIX:
        return                       # only the plain version takes it
    # the CUDA kernel's limits, held on every device alike
    row = d * q.element_size()
    if row < 32 or row > 512 or row & (row - 1):
        raise ValueError(f"paged_decode_attention: a K/V row of {row} bytes; "
                         f"the kernel takes D * element size a power of two "
                         f"from 32 to 512 bytes")
    g = qh // kvh
    smem = smem_bytes(k_pages.shape[1], d, g, q.element_size())
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged_decode_attention: {smem} bytes of shared "
                         f"memory a block (page size {k_pages.shape[1]}, D "
                         f"{d}); the kernel has at most {SMEM_LIMIT}")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if x.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} is not "
                             f"16-byte aligned")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           seq_lens: torch.Tensor) -> torch.Tensor:
    """ΔTree-paged GQA decode attention.

    q:            (B, QH, D) float32 or bfloat16
    k/v_pages:    (NP, PS, KVH, D), q's dtype (read in place)
    block_tables: (B, MAXP) int32 physical page ids (-1 = unused); every
                  page below ceil(seq_len / PS) must be mapped
    seq_lens:     (B,) int32
    Returns (B, QH, D) in q.dtype; a sequence of length 0 gives 0.
    """
    _check(q, k_pages, v_pages, block_tables, seq_lens)
    if q.device.type == "cpu":
        return ref.ref_paged_decode_attention(q, k_pages, v_pages,
                                              block_tables, seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    if q.dtype not in _SUFFIX:
        raise TypeError(f"paged_decode_attention: the kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    dev = q.device
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("seq_lens", seq_lens)):
        if x.device != dev:
            raise ValueError(f"paged_decode_attention: {name} is on "
                             f"{x.device}, expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"contiguous")
    b, qh, d = q.shape
    np_, ps, kvh, _ = k_pages.shape
    maxp = block_tables.shape[1]
    g = qh // kvh
    out = torch.empty_like(q)
    if b == 0:
        return out
    # a (b, KV head, sub-group) is one block of a chunk's grid
    splits, pps = split_plan(b, kvh * subgroups(g)[0], maxp,
                             _sm_count(dev.index))
    part = (torch.empty(b * kvh * splits * g * (d + 2), dtype=torch.float32,
                        device=dev) if splits > 1 else None)
    fn = _kernel_fn(q.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), seq_lens.data_ptr(), b, np_, ps, kvh,
                 d, g, maxp, splits, pps, 1.0 / d ** 0.5,
                 None if part is None else part.data_ptr(), out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: CUDA launch failed "
                           f"(cudaError {err}; {splits} splits of {pps} "
                           f"pages, {smem_bytes(ps, d, g, q.element_size())} "
                           f"bytes of shared memory a block)")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
