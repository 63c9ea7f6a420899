"""Hand-written CUDA kernels for Hopper and the walk loops around them (port
of ``repro.kernels``).

- csrc/veb_walk.cu — the vEB walk kernels (fused multi-round, and one
  round over pre-gathered rows)
- csrc/veb_scan.cu — the emit-cursor range-scan kernel
- csrc/paged_attention.cu — the ΔTree-paged decode-attention kernel
- build.py         — nvcc build at first use, ctypes loading
- veb_search.py    — the wrappers (CUDA tensor -> kernel, CPU -> ref)
- delta_paged_attention.py — the paged-attention wrapper, likewise
- ref.py           — the plain PyTorch versions (CPU path, ground truth)
- ops.py           — the multi-round walk and the scan (public API)
- autotune.py      — the walks' block size per height (sweep, cache, table)

The package exports the JAX package's kernel API bar ``default_interpret``
(Pallas's interpreter switch, which has no counterpart here).  Importing
it builds and loads nothing: `build.py` compiles a kernel at its first
launch.
"""

from repro_torch.kernels.delta_paged_attention import paged_decode_attention
from repro_torch.kernels.ops import delta_contains, delta_search, delta_walk

__all__ = ["delta_search", "delta_contains", "delta_walk",
           "paged_decode_attention"]
