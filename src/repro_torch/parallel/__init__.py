"""Distribution layer (port of ``repro.parallel``): logical-axis sharding
rules, parameter / cache / batch specs and placing trees on a mesh,
split-K sharded decode attention; `comm` holds the collectives they run.

``__all__`` is the JAX package's surface; the mesh helpers are
re-exported from `repro_torch.launch.mesh` so mesh plumbing has one
import home.
"""

from repro_torch.launch.mesh import make_forest_mesh, make_host_mesh
from repro_torch.parallel.ax import (
    DEFAULT_RULES,
    constrain,
    logical_rules,
    spec_for,
)
from repro_torch.parallel.decode_attn import split_k_decode_attention
from repro_torch.parallel.shardings import (
    batch_axes,
    batch_spec,
    cache_specs,
    opt_specs,
    param_specs,
    to_named,
)

__all__ = [
    "DEFAULT_RULES",
    "batch_axes",
    "batch_spec",
    "cache_specs",
    "constrain",
    "logical_rules",
    "make_forest_mesh",
    "make_host_mesh",
    "opt_specs",
    "param_specs",
    "spec_for",
    "split_k_decode_attention",
    "to_named",
]
