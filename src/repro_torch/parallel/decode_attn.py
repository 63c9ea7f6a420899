"""Split-K sharded decode attention, flash-decoding style (port of
``repro.parallel.decode_attn``).

The decode KV cache is sharded along *sequence* on the "model" axis
(`shardings.cache_specs`).  Instead of gathering the cache for the
softmax, each rank computes a float32 partial (max, sum, out) over its
S / n slice and the ranks combine with an all-reduce MAX of the maxima
and one all-reduce SUM of the rescaled sums and outputs: wire traffic
O(B·H·D) instead of O(B·S·KVH·D).  Plain PyTorch, as JAX's is plain
``jnp`` under ``shard_map`` (it is no Pallas kernel); the collectives are
`parallel.comm`'s.  `block_decode_attention` is the same over a cache a
rank holds only its block of (the models' sharded decode,
`attention.decode_sharded`), and `merge_partials` the merge MLA's
absorbed decode shares.
"""

from __future__ import annotations

import math

import torch

from repro_torch.parallel import comm as C
from repro_torch.parallel.ax import axis_of

NEG_INF = -1e30


def _local_partial(q, k, v, length, s0: int):
    """Partial attention over a local KV slice starting at position s0."""
    b, _, h, d = q.shape
    s_loc, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.reshape(b, kvh, g, d).float()
    sc = torch.einsum("bhgd,bshd->bhgs", qf, k.float()) / math.sqrt(d)
    pos = s0 + torch.arange(s_loc, device=q.device)
    sc = torch.where((pos[None, :] < length[:, None])[:, None, None], sc,
                     NEG_INF)
    m = torch.amax(sc, dim=-1)                   # (B,KVH,G)
    p = torch.exp(sc - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return m, l, o


def merge_partials(m, l, o, groups):
    """The softmax-weighted output of float32 partials (max ``m``, sum
    ``l``, output ``o``) over disjoint slices of the keys, one a rank of
    ``groups``: an all-reduce MAX of the maxima, then one all-reduce SUM
    of the rescaled sums and outputs a group.  No groups: ``o / l``."""
    mm = m
    for g in groups:
        mm = C.all_reduce(mm, g, "max")
    alpha = torch.exp(m - mm)
    lo = torch.cat([(l * alpha)[..., None], o * alpha[..., None]], dim=-1)
    for g in groups:
        lo = C.all_reduce(lo, g)
    return lo[..., 1:] / torch.clamp(lo[..., :1], min=1e-30)


def block_decode_attention(q, k_block, v_block, length, s0: int, groups):
    """Split-K decode attention of a rank's cache block: q (B,1,H,D) with
    every head; blocks (B,S_loc,KVH,D) holding positions [s0, s0 +
    S_loc); length (B,).  The partials merge over ``groups`` (the ranks
    holding the other blocks).  Returns (B,1,H,D) in q's dtype."""
    m, l, o = _local_partial(q, k_block, v_block, length, s0)
    out = merge_partials(m, l, o, groups)
    b, kvh, g, d = out.shape
    return out.reshape(b, 1, kvh * g, d).to(q.dtype)


@torch.no_grad()
def split_k_decode_attention(mesh, q, k_cache, v_cache, length,
                             axis: str = "model"):
    """q: (B,1,H,D), the same on every rank of `axis`; caches: (B,S,KVH,D),
    every rank's whole cache, of which each reads its S / n slice (as
    ``shard_map``'s in_specs cut JAX's); length: (B,).  Plain tensors.
    Returns (B,1,H,D) on every rank."""
    n, i, group = axis_of(mesh, mesh.mesh_dim_names.index(axis))
    s = k_cache.shape[1]
    if s % n:
        raise ValueError(f"a cache of {s} positions does not split over "
                         f"{n} ranks")
    s_loc = s // n
    kc = k_cache[:, i * s_loc:(i + 1) * s_loc]
    vc = v_cache[:, i * s_loc:(i + 1) * s_loc]
    return block_decode_attention(q, kc, vc, length, i * s_loc,
                                  [] if n == 1 else [group])
