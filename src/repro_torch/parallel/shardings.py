"""Parameter / cache / batch PartitionSpecs for the mesh, and placing trees
on it (port of ``repro.parallel.shardings``).

Scheme (DESIGN.md §7): TP on "model" (heads / FFN hidden / experts /
vocab), FSDP on "data" for every large matrix, batch on ("pod", "data").
The JAX package's scan-stacked leaves carry a leading (reps,) axis; the
port's per-layer leaves do not, so their specs are JAX's with that
leading None dropped (the rule pads on the left to the leaf's rank).

`param_specs` walks a model's ``named_parameters()`` (or a name ->
tensor dict): a leaf's rule keys on the last name component, as JAX's
keys on the dict key, and a MoE expert tensor is known by a sibling
``router``.  `cache_specs` and `batch_spec` read only the mesh's axis
sizes by name (`axis_sizes`: a ``DeviceMesh`` or a name -> size
mapping), so they can be computed for meshes larger than the process
group.  `to_named` gives `NamedSharding`s (mesh, spec, DTensor
placements); `shard_params` / `shard_state` / `shard_batch` are the
counterpart of ``jax.device_put(tree, shardings)``: each rank keeps only
its block (every rank holds the whole value first: the same seed draws
the same weights, the same pipeline step the same batch).  A block may
lie on the meta device whatever the mesh's device type (the dry-run's
production mesh is a CPU mesh of a fake group holding meta blocks).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.parallel.ax import (
    P,
    block_index,
    mesh_shape,
    placements_for,
    wrap,
)

# name -> spec over the *trailing* dims (leading stack axes padded with None)
_TRAILING_RULES: dict[str, tuple] = {
    # embedding
    "tok": ("model", "data"),        # (V, D)
    "head": ("data", "model"),       # (D, V)
    # attention
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "bq": ("model",),
    "bk": ("model",),
    "bv": ("model",),
    # MLA
    "wq_a": ("data", "model"),
    "wq_b": ("data", "model"),
    "wkv_a": ("data", None),
    "wkv_b": ("data", "model"),
    # MLP (rank 2) / MoE experts (rank 3) — dispatched on rank below
    "w_gate": ("data", "model"),
    "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    "w_in": ("data", "model"),
    "b_in": ("model",),
    "w_out": ("model", "data"),
    "b_out": (None,),
    "router": (None, None),
    # mamba2
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "a_log": (None,),
    "d_skip": (None,),
    "dt_bias": (None,),
    "gate_norm": (None,),
    # norms
    "scale": (None,),
    "bias": (None,),
}

_MOE_RULES = {  # rank-3 expert tensors: EP on "model", FSDP inside expert
    "w_gate": ("model", "data", None),
    "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
}


def _leaf_spec(name: str, ndim: int, in_moe: bool) -> P:
    base = None
    if in_moe and name in _MOE_RULES:
        base = _MOE_RULES[name]
    elif name in _TRAILING_RULES:
        base = _TRAILING_RULES[name]
    if base is None:
        return P()
    pad = ndim - len(base)
    if pad < 0:
        raise ValueError(f"{name}: a {ndim}-d leaf under the rule {base}")
    return P(*((None,) * pad + tuple(base)))


def param_specs(params) -> dict:
    """{name: PartitionSpec} for a model's ``named_parameters()`` (or a
    dict of name -> tensor)."""
    named = dict(params.named_parameters() if isinstance(params, nn.Module)
                 else params)
    moe_parents = {n.rpartition(".")[0] for n in named
                   if n.rpartition(".")[2] == "router"}
    return {n: _leaf_spec(n.rpartition(".")[2], len(t.shape),
                          n.rpartition(".")[0] in moe_parents)
            for n, t in named.items()}


def opt_specs(pspecs):
    """AdamW state specs: moments shard like params; step replicated."""
    return {"m": pspecs, "v": pspecs, "step": P()}


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of a name -> size
    mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh_shape(mesh)))


_CACHE_RULES = {
    # (B, S, KVH, HD): shard cache length on "model" (split-K decode)
    "k": (("pod", "data"), "model", None, None),
    "v": (("pod", "data"), "model", None, None),
    "ck": (("pod", "data"), "model", None, None),
    "cv": (("pod", "data"), "model", None, None),
    # MLA latent caches (B, S, r)
    "ckv": (("pod", "data"), "model", None),
    "krope": (("pod", "data"), "model", None),
    # SSD state (B, H, P, N) / conv cache (B, w-1, CD)
    "state": (("pod", "data"), "model", None, None),
    "conv": (("pod", "data"), None, "model"),
}


def _cache_leaf_spec(name: str, shape, sizes: dict) -> P:
    trailing = _CACHE_RULES[name]
    pad = len(shape) - len(trailing)
    if pad < 0:
        raise ValueError(f"cache leaf {name}: {len(shape)}-d under "
                         f"{trailing}")
    spec = (None,) * pad + tuple(trailing)
    parts = []
    for dim, ax in zip(shape, spec):
        axes = (ax,) if isinstance(ax, str) else (ax or ())
        keep = tuple(a for a in axes if a in sizes)
        size = 1
        for a in keep:
            size *= sizes[a]
        parts.append(keep if dim % max(size, 1) == 0 and keep else None)
    parts = [p[0] if isinstance(p, tuple) and len(p) == 1 else p
             for p in parts]
    return P(*parts)


def cache_specs(caches, mesh):
    """Decode-cache specs (the caches' structure, a spec a leaf keyed by
    its dict key); drops mesh axes whose size doesn't divide dims."""
    sizes = axis_sizes(mesh)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key) for v in node)
        return _cache_leaf_spec(key, tuple(node.shape), sizes)

    return walk(caches)


def batch_axes(mesh, batch_size: int):
    """Largest prefix of ("pod","data") whose product divides batch_size."""
    sizes = axis_sizes(mesh)
    chosen, prod = [], 1
    for a in ("pod", "data"):
        if a in sizes and batch_size % (prod * sizes[a]) == 0:
            chosen.append(a)
            prod *= sizes[a]
    return tuple(chosen)


def batch_spec(mesh, batch_size: int, ndim: int) -> P:
    ax = batch_axes(mesh, batch_size)
    first = ax if len(ax) > 1 else (ax[0] if ax else None)
    return P(*((first,) + (None,) * (ndim - 1)))


# --------------------------------------------------------------------------
# placing trees on the mesh
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: JAX's ``NamedSharding``; ``placements`` are its
    DTensor placements."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)

    def _check(self, device) -> str:
        device = self.mesh.device_type if device is None else device
        if torch.device(device).type not in (self.mesh.device_type, "meta"):
            raise ValueError(f"a tensor for {device} on a "
                             f"{self.mesh.device_type} mesh")
        if self.mesh.get_coordinate() is None:
            raise ValueError("this rank is not in the mesh")
        return device

    def place(self, full: torch.Tensor, device=None):
        """This rank's block of ``full`` (every rank's same whole value) as
        a DTensor on the mesh, copied to ``device`` (the mesh's device type
        by default) after the cut; a 0-d value stays a plain tensor."""
        if full.ndim == 0:
            return full.to(self.mesh.device_type if device is None
                           else device)
        device = self._check(device)
        full = full.detach()
        idx = block_index(full.shape, mesh_shape(self.mesh),
                          self.placements, self.mesh.get_coordinate())
        loc = full[idx].to(device).contiguous()
        if (loc.untyped_storage().data_ptr()
                == full.untyped_storage().data_ptr()):
            loc = loc.clone()      # keep no view of the whole tensor
        return wrap(loc, self.mesh, self.placements, full.shape)

    def place_block(self, block: torch.Tensor, device=None):
        """This rank's ``block`` (already cut) as a DTensor on the mesh."""
        device = self._check(device)
        shape = list(block.shape)
        for k, p in enumerate(self.placements):
            if p.is_shard():
                shape[p.dim] *= self.mesh.size(k)
        return wrap(block.to(device).contiguous(), self.mesh,
                     self.placements, shape)


def _is_spec(x) -> bool:
    return isinstance(x, P)


def to_named(tree_specs, mesh):
    """The specs' tree with each spec a `NamedSharding` on ``mesh``."""
    def walk(node):
        if _is_spec(node):
            return NamedSharding(mesh, node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        raise TypeError(f"not a spec: {node!r}")
    return walk(tree_specs)


def shard_state(tree, shardings, device=None):
    """``tree`` (dicts / lists / tuples of tensors) placed by the matching
    tree of `NamedSharding`s."""
    if isinstance(tree, dict):
        return {k: shard_state(v, shardings[k], device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_state(v, s, device)
                          for v, s in zip(tree, shardings))
    return shardings.place(torch.as_tensor(tree), device)


@torch.no_grad()
def shard_params(model: nn.Module, shardings: dict) -> nn.Module:
    """Replace each parameter of ``model`` (named as ``shardings``' keys)
    by its DTensor block, in place; the whole tensors are let go.  The
    parameters keep ``requires_grad``."""
    for name, p in list(model.named_parameters()):
        sh = shardings[name]
        if isinstance(p, DTensor):
            raise ValueError(f"{name} is placed already")
        mod = model.get_submodule(name.rpartition(".")[0])
        dt = sh.place(p.data, p.device)
        mod._parameters[name.rpartition(".")[2]] = nn.Parameter(
            dt, requires_grad=p.requires_grad)
    return model


def shard_batch(batch: dict, mesh, device=None) -> dict:
    """A batch's leaves of rank >= 2 placed by `batch_spec` (rows over the
    data axes), the others as plain tensors on the device."""
    device = mesh.device_type if device is None else device
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.ndim >= 2:
            sh = NamedSharding(mesh, batch_spec(mesh, t.shape[0], t.ndim))
            out[k] = sh.place(t, device)
        else:
            out[k] = t.to(device)
    return out


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's block of a DTensor; a plain tensor itself."""
    return t._local_tensor if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """Bytes this rank stores for the tensors of ``tree`` (a DTensor's
    block only)."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    t = local(tree)
    return t.numel() * t.element_size()
