"""repro_torch — the ΔTree system ported to PyTorch and CUDA (NVIDIA H100).

A second package beside the JAX reference ``repro``, with the same
subpackage layout (``core``, ``kernels``, ``maintenance``, ``obs``, ``api``)
so each module's counterpart sits at the same path.  It imports torch and
numpy only, never jax or ``repro``.

So far it holds the main path: the single-arena ΔTree index as
``make_index("deltatree", engine="lockstep")`` serves it — bulk build,
wait-free reads through the CUDA vEB walk kernels, and eager batched
updates.  ROADMAP.md lists what is still to port.
"""
