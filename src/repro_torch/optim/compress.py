"""Int8 gradient / delta compression (port of ``repro.optim.compress``).

Per-tensor symmetric int8 quantization with a float32 scale, and the
int8-compressed mean over a mesh axis (``compressed_pmean``) that the
JAX package's cross-pod sync uses.
"""

from __future__ import annotations

import torch

from repro_torch.parallel import comm as C
from repro_torch.parallel.ax import axis_of


def quantize_int8(x: torch.Tensor):
    """(q int8, scale float32): ``x`` ~ q * scale, |q| <= 127."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_pmean(tree, mesh, axis: str):
    """int8-compressed mean of each rank's tensors over the mesh axis
    ``axis`` (JAX's, used inside ``shard_map``: each leaf is this rank's
    own value, a plain tensor).

    Quantize locally, all-gather the int8 payload with the float32 scale
    beside it (one collective a leaf; the wire stays int8), then
    dequantize each rank's block with its own scale and average in rank
    order.  Exact w.r.t. the per-rank quantization (no scale mixing).
    Returns the tree with each leaf the mean, in the leaf's dtype."""
    n, _, group = axis_of(mesh, mesh.mesh_dim_names.index(axis))

    def one(x):
        q, s = quantize_int8(x)
        wire = torch.cat([q.reshape(-1).view(torch.uint8),
                          s.reshape(1).view(torch.uint8)])
        got = wire[None] if n == 1 else C.all_gather(wire[None], group)
        qs = got[:, :-4].contiguous().view(torch.int8)
        ss = got[:, -4:].contiguous().view(torch.float32)
        acc = qs[0].float() * ss[0]
        for r in range(1, n):
            acc = acc + qs[r].float() * ss[r]
        return (acc / n).reshape(x.shape).to(x.dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return one(node)

    return walk(tree)
