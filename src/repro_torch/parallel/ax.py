"""Logical activation-axis sharding (port of ``repro.parallel.ax``), and the
hand-written redistributions the sharded trainer runs on.

Models annotate activations with *logical* axis names; a process-wide rule
set (installed by the launcher under a mesh) maps them to mesh axes.
Outside a rules context every annotation is a no-op, so model code runs
unchanged on one device.  Under rules `constrain` redistributes a DTensor
to the placements `spec_for` gives (JAX's ``with_sharding_constraint``;
JAX's own ``constrain`` raises on a mesh with explicit axes, ROADMAP
Queue 3), less the axes that do not divide a dimension.

A sharded parameter is a ``torch.distributed.tensor.DTensor``: each rank
stores its block, and ops that need no communication run through
DTensor's own rules.  Every redistribution is this module's, written by
hand over `comm`'s collectives (`redistribute_local`): DTensor's own
all-gather over gloo with CUDA tensors crashed the process on the card
(torch 2.11, four processes sharing one card).  `axis_of`, `wrap` and
`grad_placements` are what the ops written by hand over blocks build
on.  The differentiable forms:

- `redistribute(x, placements)`: the backward brings the gradient back
  to ``x``'s placements, a partial sum reduced (Megatron's f / g pair is
  `constrain` at the edges of a tensor-parallel region);
- `gathered(w)`: a weight as a product reads it, its "data" / "pod"
  shards all-gathered (FSDP; the backward reduce-scatters the gradient);
- `local_map(fn, ...)`: ``fn`` over this rank's blocks, brought to given
  placements, its output a given layout (``Partial`` entries being
  summands); the backward differentiates ``fn``'s local graph (under
  activation checkpointing, ``fn`` run again on the kept blocks) and
  sums each input's gradient where the forward replicated it.

Shards are even (torch.chunk's split with no remainder): an uneven one
raises.
"""

from __future__ import annotations

import contextlib
import types

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.parallel import comm as C

# process-wide, not thread-local: the autograd engine runs a CUDA
# backward (and activation checkpointing's recompute inside it) on a
# device thread of its own, which must see the same rules
_state = types.SimpleNamespace(mesh=None, rules=None)

# default logical-name -> mesh-axes mapping used by the production mesh
DEFAULT_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),     # pod axis collapses onto data when absent
    "seq": None,
    "decode_seq": "model",        # sharded KV cache length (split-K decode)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_cap": ("pod", "data"),
    "ssm_inner": "model",
    "state": None,
}

DATA_AXES = ("pod", "data")       # FSDP's axes: weights gather over them


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry a dimension, each None, a mesh
    axis name or a tuple of names (major first)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


P = PartitionSpec


@contextlib.contextmanager
def logical_rules(mesh, rules: dict | None = None):
    """Activate logical-axis constraint rules for `constrain` calls."""
    _state.mesh = mesh
    _state.rules = dict(DEFAULT_RULES if rules is None else rules)
    try:
        yield
    finally:
        _state.mesh = None
        _state.rules = None


def _axis_names(mesh) -> tuple:
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def mesh_shape(mesh) -> tuple:
    """The sizes of ``mesh``'s dimensions (read without building the rank
    tensor ``mesh.mesh``, whose ops a count would see on the host)."""
    return tuple(mesh.size(k) for k in range(mesh.ndim))


def spec_for(*names: str | None) -> P:
    """Translate logical names to a PartitionSpec under the active rules."""
    rules = getattr(_state, "rules", None)
    mesh = getattr(_state, "mesh", None)
    axis_names = _axis_names(mesh)
    parts = []
    for n in names:
        axes = rules.get(n) if (rules and n) else None
        if axes is None:
            parts.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        present = tuple(a for a in axes if a in axis_names)
        parts.append(present if len(present) > 1
                     else (present[0] if present else None))
    return P(*parts)


def placements_for(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: mesh axis k shards
    the tensor dimension whose entry names it, else replicates.  An entry
    naming several axes shards over them major first (mesh order)."""
    names = _axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        prev = -1
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not in the "
                                 f"mesh's {names}")
            k = names.index(a)
            if k < prev:
                raise ValueError(f"spec {spec}: axes {axes} are not in the "
                                 f"mesh's order {names}")
            prev = k
            out[k] = Shard(d)
    return tuple(out)


# --------------------------------------------------------------------------
# redistribution by hand
# --------------------------------------------------------------------------


def axis_of(mesh, k: int):
    """(size, this rank's coordinate, group) of mesh dimension k."""
    n = mesh.size(k)
    if n == 1:
        return 1, 0, None
    return n, mesh.get_local_rank(k), mesh.get_group(k)


def _chunk(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"evenly over {n} ranks")
    return t.chunk(n, dim)[i].contiguous()


def redistribute_local(t: torch.Tensor, mesh, src, dst) -> torch.Tensor:
    """This rank's block of a tensor laid out as ``src`` on ``mesh``, laid
    out as ``dst``: Shard -> Replicate all-gathers, Partial -> Replicate
    all-reduces, Partial -> Shard reduce-scatters, Replicate -> Shard
    keeps this rank's chunk (no communication).  Unsharding runs from the
    last mesh dimension to the first, the rest in mesh order, so blocks
    nested over several mesh dimensions come out right."""
    src, dst = list(src), list(dst)
    cur = list(src)
    undo = set()
    for k in reversed(range(len(cur))):
        if cur[k].is_shard() and (cur[k] != dst[k] or any(
                j > k and cur[j] == cur[k] for j in undo)):
            undo.add(k)
    for k in sorted(undo, reverse=True):
        n, _, g = axis_of(mesh, k)
        if n > 1:
            t = C.all_gather(t, g, cur[k].dim)
        cur[k] = Replicate()
    for k in range(len(cur)):
        if cur[k] == dst[k]:
            continue
        n, i, g = axis_of(mesh, k)
        if cur[k].is_partial():
            if dst[k].is_replicate():
                t = t if n == 1 else C.all_reduce(t, g)
            elif dst[k].is_shard():
                t = t if n == 1 else C.reduce_scatter(t, g, dst[k].dim)
            else:
                raise ValueError(f"cannot go from {cur[k]} to {dst[k]}")
        elif cur[k].is_replicate() and dst[k].is_shard():
            t = _chunk(t, dst[k].dim, n, i)
        else:
            raise ValueError(f"cannot go from {cur[k]} to {dst[k]}")
        cur[k] = dst[k]
    return t


def grad_placements(placements) -> tuple:
    """A gradient's layout for a tensor laid out as ``placements``: a
    partial sum's gradient is the whole gradient on every rank."""
    return tuple(Replicate() if p.is_partial() else p for p in placements)


def _contiguous_strides(shape) -> tuple:
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(n, 1)
    return tuple(reversed(out))


def wrap(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    stride = _contiguous_strides(shape)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


class _Redistribute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, placements):
        ctx.mesh, ctx.src = x.device_mesh, tuple(x.placements)
        loc = redistribute_local(x._local_tensor, ctx.mesh, x.placements,
                                 placements)
        return wrap(loc, ctx.mesh, placements, x.shape)

    @staticmethod
    def backward(ctx, g):
        want = grad_placements(ctx.src)
        loc = redistribute_local(g._local_tensor, ctx.mesh, g.placements,
                                 want)
        return wrap(loc, ctx.mesh, want, g.shape), None


def redistribute(x, placements):
    """``x`` (a DTensor) laid out as ``placements``, differentiably; a plain
    tensor passes through."""
    if not isinstance(x, DTensor):
        return x
    return _Redistribute.apply(x, tuple(placements))


def constrain(x, *names: str | None):
    """``x`` laid out as the logical ``names`` say under the active rules
    (JAX's ``with_sharding_constraint``); a no-op without rules, and for a
    plain tensor (this process's whole value)."""
    mesh = getattr(_state, "mesh", None)
    if mesh is None or not isinstance(x, DTensor):
        return x
    if len(names) != x.ndim:
        raise ValueError(f"{len(names)} names for a {x.ndim}-d tensor "
                         f"{tuple(x.shape)}: {names}")
    spec = _dividing(spec_for(*names), x.shape, x.device_mesh)
    return redistribute(x, placements_for(spec, x.device_mesh))


def _dividing(spec, shape, mesh) -> P:
    """``spec`` with each dimension's mesh axes cut to the longest prefix
    whose sizes' product divides the dimension (`shardings.batch_axes`'
    rule: long_500k's one row lies on no axis)."""
    sizes = dict(zip(_axis_names(mesh), mesh_shape(mesh)))
    parts = []
    for entry, dim in zip(spec, shape):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        keep, prod = [], 1
        for a in axes:
            if dim % (prod * sizes[a]):
                break
            keep.append(a)
            prod *= sizes[a]
        parts.append(tuple(keep) if len(keep) > 1
                     else (keep[0] if keep else None))
    return P(*parts)


def gathered(w):
    """``w`` as a product reads it: a DTensor's shards over the data axes
    all-gathered (FSDP), its "model" shards kept; a plain tensor as is."""
    if not isinstance(w, DTensor):
        return w
    names = _axis_names(w.device_mesh)
    want = tuple(Replicate() if names[k] in DATA_AXES else p
                 for k, p in enumerate(w.placements))
    return w if want == tuple(w.placements) else redistribute(w, want)


def like(t, x):
    """``t`` (a tensor every rank holds whole) as a replicated DTensor on
    ``x``'s mesh when ``x`` is a DTensor, else ``t``."""
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def block_index(shape, mesh_shape, placements, coord) -> tuple:
    """The slices of a tensor of ``shape`` that the rank at ``coord`` of a
    mesh of ``mesh_shape`` holds under ``placements`` (even chunks, mesh
    dimensions in order)."""
    lo, size = [0] * len(shape), list(shape)
    for n, p, c in zip(mesh_shape, placements, coord):
        if p.is_shard():
            if size[p.dim] % n:
                raise ValueError(f"{tuple(shape)} does not split over {n} "
                                 f"ranks along {p.dim}")
            size[p.dim] //= n
            lo[p.dim] += c * size[p.dim]
    return tuple(slice(a, a + b) for a, b in zip(lo, size))


def local_offset(mesh, placements, dim: int, size: int) -> tuple[int, int]:
    """(offset, length) of this rank's block of dimension ``dim`` (of
    global length ``size``) under ``placements``."""
    off = 0
    for k, p in enumerate(placements):
        if p == Shard(dim):
            n, i, _ = axis_of(mesh, k)
            if size % n:
                raise ValueError(f"{size} does not split over {n} ranks")
            size //= n
            off += i * size
    return off, size


def _under_checkpoint() -> bool:
    """Whether saved-tensor hooks are active: activation checkpointing's
    forward (or its recompute) is running."""
    top = getattr(torch._C._autograd, "_top_saved_tensors_default_hooks",
                  None)
    return top is not None and top(False) is not None


class _LocalMap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, mesh, views, out_view, out_placements, *args):
        ctx.mesh, ctx.views, ctx.out_view = mesh, views, out_view
        ctx.src = [tuple(a.placements) if isinstance(a, DTensor) else None
                   for a in args]
        leaves, grad_at = [], []
        for a, v in zip(args, views):
            if isinstance(a, DTensor):
                loc = redistribute_local(a._local_tensor, mesh, a.placements,
                                         v)
                if a.requires_grad:
                    loc = loc.detach().requires_grad_(True)
                    grad_at.append(len(leaves))
                leaves.append(loc)
            else:
                leaves.append(a)
        ctx.fn, ctx.grad_at = fn, grad_at
        # under activation checkpointing the region's blocks are kept and
        # ``fn`` is run again in the backward (its own remat): a local
        # graph's tensors packed by the checkpoint's hooks would be
        # unpacked by the backward's own `autograd.grad`, a graph task of
        # its own, each unpack recomputing the whole region once more
        ctx.remat = _under_checkpoint()
        if ctx.remat:
            with torch.no_grad():
                out = fn(*leaves)
            kept = [t for t in leaves if isinstance(t, torch.Tensor)]
            ctx.save_for_backward(*kept)
            ctx.other = [None if isinstance(t, torch.Tensor) else t
                         for t in leaves]
            ctx.graph = None
        else:
            with torch.enable_grad():
                out = fn(*leaves)
            ctx.graph = (out, [leaves[i] for i in grad_at])
        ctx.shape = [a.shape if isinstance(a, DTensor) else None
                     for a in args]
        loc = redistribute_local(out.detach().contiguous(), mesh, out_view,
                                 out_placements)
        shape = list(out.shape)
        for k, p in enumerate(out_view):
            if p.is_shard():
                shape[p.dim] *= mesh.size(k)
        ctx.out_shape = shape
        return wrap(loc, mesh, out_placements, shape)

    @staticmethod
    def _replay(ctx):
        """(output, leaves needing gradients) of ``fn`` run again on the
        kept blocks, with autograd on."""
        kept = iter(ctx.saved_tensors)
        leaves = [next(kept) if o is None else o for o in ctx.other]
        leaves = [t.detach().requires_grad_(True) if i in ctx.grad_at else t
                  for i, t in enumerate(leaves)]
        with torch.enable_grad():
            out = ctx.fn(*leaves)
        return out, [leaves[i] for i in ctx.grad_at]

    @staticmethod
    def backward(ctx, g):
        out, inputs = (_LocalMap._replay(ctx) if ctx.remat else ctx.graph)
        ctx.graph = None
        grad_at = ctx.grad_at
        mesh = ctx.mesh
        g_loc = redistribute_local(g._local_tensor, mesh, g.placements,
                                   grad_placements(ctx.out_view))
        grads = torch.autograd.grad(out, inputs, g_loc, allow_unused=True)
        res = [None] * len(ctx.views)
        for i, gi in zip(grad_at, grads):
            if gi is None:
                continue
            gi = gi.contiguous()
            view = ctx.views[i]
            label = tuple(
                Partial() if v.is_replicate() and not o.is_replicate() else v
                for v, o in zip(view, ctx.out_view))
            want = grad_placements(ctx.src[i])
            loc = redistribute_local(gi, mesh, label, want)
            res[i] = wrap(loc, mesh, want, ctx.shape[i])
        return (None, None, None, None, None, *res)


def local_map(fn, mesh, args, views, out_view, out_placements):
    """``fn(*blocks)`` where each DTensor of ``args`` is first brought to
    its placements in ``views`` (other args pass as they are); ``fn``'s
    output is this rank's block under ``out_view`` (a ``Partial`` entry: a
    summand over that mesh dimension), brought to ``out_placements``.
    Differentiable: ``fn``'s local graph is kept for the backward."""
    return _LocalMap.apply(fn, mesh, tuple(map(tuple, views)),
                           tuple(out_view), tuple(out_placements), *args)


# --------------------------------------------------------------------------
# the pieces the sharded layers build on
# --------------------------------------------------------------------------


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        for g in groups:
            x = C.all_reduce(x, g)
        return x

    @staticmethod
    def backward(ctx, g):
        for gr in ctx.groups:
            g = C.all_reduce(g, gr)
        return g, None


def psum(x: torch.Tensor, groups) -> torch.Tensor:
    """The sum of this rank's block ``x`` over ``groups`` (process groups;
    None entries skipped), differentiable: every rank's downstream block
    depends on the sum, so the backward sums the gradient over them too."""
    groups = tuple(g for g in groups if g is not None)
    return _PSum.apply(x, groups) if groups else x


def split_heads(t, heads: int):
    """(..., heads * hd) -> (..., heads, hd).  A DTensor's shards of the last
    dimension stay on the heads where ``heads`` splits over the mesh
    dimension; where it does not, that dimension is gathered first and
    every rank holds every head (as `attention._attend_sharded` replicates
    heads fewer than the ranks)."""
    if not isinstance(t, DTensor):
        return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)
    mesh, d = t.device_mesh, t.ndim - 1
    view = tuple(Replicate() if p == Shard(d) and heads % mesh.size(k)
                 else p for k, p in enumerate(t.placements))
    hd = t.shape[-1] // heads
    return local_map(lambda x: x.reshape(*x.shape[:-1], -1, hd), mesh, (t,),
                     (view,), view, view)


def merge_heads(t):
    """(..., H, hd) -> (..., H * hd); a DTensor's head shards become shards
    of the merged dimension."""
    if not isinstance(t, DTensor):
        return t.reshape(*t.shape[:-2], -1)
    pl = tuple(t.placements)
    return local_map(lambda x: x.reshape(*x.shape[:-2], -1), t.device_mesh,
                     (t,), (pl,), pl, pl)


def rows_view(placements) -> tuple:
    """``placements`` with every entry but a shard of dimension 0 (the
    rows) replicated."""
    return tuple(p if p == Shard(0) else Replicate() for p in placements)


def block(x, view) -> torch.Tensor:
    """This rank's block of the DTensor ``x`` laid out as ``view`` (not
    differentiable: for the steps that run without autograd)."""
    return redistribute_local(x._local_tensor, x.device_mesh, x.placements,
                              view)


def shard_groups(mesh, placements, dim: int) -> list:
    """The process groups of the mesh dimensions (of size > 1) that shard
    tensor dimension ``dim`` under ``placements``."""
    return [axis_of(mesh, k)[2] for k, p in enumerate(placements)
            if p == Shard(dim) and mesh.size(k) > 1]


def whole(w):
    """A DTensor weight all-gathered over every mesh dimension (every rank
    computes the product whole, as a replicated weight would); a plain
    tensor as is."""
    if not isinstance(w, DTensor):
        return w
    want = (Replicate(),) * w.device_mesh.ndim
    return w if tuple(w.placements) == want else redistribute(w, want)


def head_view(placements, heads_dim: int, to_dim: int) -> tuple:
    """Where ``placements`` shard dimension ``heads_dim`` (the heads),
    Shard(``to_dim``); Replicate elsewhere: the view of a tensor whose
    dimension ``to_dim`` is laid out by the same heads (a weight's
    columns, a partial's heads)."""
    return tuple(Shard(to_dim) if p == Shard(heads_dim) else Replicate()
                 for p in placements)
