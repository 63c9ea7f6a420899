"""ΔTree-paged decode attention: CUDA for tensors on the card, plain PyTorch
on the CPU (port of ``repro.kernels.delta_paged_attention``, the serve
path's kernel).

The pager resolves each sequence's (seq, logical block) -> page mapping
with a wait-free ΔTree lookup into a block table; this kernel reads only
the pages a sequence owns.  The CUDA kernel lives in
``csrc/paged_attention.cu`` (built at first use, `kernels.build`); the
wrapper checks its inputs, allocates the output and launches on the
current stream.  A tensor on the CPU goes to the plain version
`kernels.ref.ref_paged_decode_attention`; a CUDA tensor goes to the kernel,
and a launch the card refuses raises — there is no fallback from one to the
other.  ``paged_decode_attention.launches`` counts kernel launches: an
empty batch launches nothing, and a refused launch is not counted.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P] * 5 + [_I] * 7 + [ctypes.c_float, _P, _P]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


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
    out = torch.empty_like(q)
    if b == 0:
        return out
    fn = _kernel_fn(q.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), seq_lens.data_ptr(), b, np_, ps, kvh,
                 d, qh // kvh, maxp, 1.0 / d ** 0.5, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: CUDA launch failed "
                           f"(cudaError {err}; shared memory needs at most "
                           f"48 KB and PS * D at most 4096)")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
