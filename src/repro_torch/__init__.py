"""repro_torch — the ΔTree system ported to PyTorch and CUDA (NVIDIA H100).

A second package beside the JAX reference ``repro``, with the same
subpackage layout (``core``, ``kernels``, ``maintenance``, ``obs``, ``api``)
so each module's counterpart sits at the same path.  It imports torch and
numpy only, never jax or ``repro``.

It holds the single-arena ΔTree index as ``make_index("deltatree",
engine="lockstep")`` serves it (bulk build, wait-free reads and range scans
through the CUDA vEB kernels, batched updates under every maintenance
policy), the DeltaForest, the paper's comparison structures, read-path
statistics and transfer accounting, and the dense serve path.  ROADMAP.md
lists what is still to port.
"""
