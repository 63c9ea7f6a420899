"""GQA attention: naive (short prompts), chunked flash (long prompts), and
decode against a dense cache (port of ``repro.models.layers.attention``).

None of these is a TPU kernel in the JAX package, so they stay plain
PyTorch here: products through ``torch.matmul`` / ``einsum``, the scores
and softmax in float32.  The paged decode path does not use them: it runs
`repro_torch.kernels.delta_paged_attention`.  ``decode_attention`` is the
dense-cache oracle the serve path is held against.

Sharded (DTensor activations, `repro_torch.parallel`): the projections
read their weights through `parallel.ax.gathered`, and `attend` runs the
same attention on each rank's rows and heads (`parallel.ax.local_map`):
the query heads on "model" where they split, each rank with the KV
heads its query heads read (the KV heads gathered first where they are
fewer than the ranks, `ax.split_heads`), else every head on every rank.
A cache sharded along its length (`shardings.cache_specs`) is written
by `fill_block` (a prompt: each rank its block of positions) and
`decode_sharded` (one token: a masked write on the rank whose block
holds the position, then split-K attention over the blocks,
`parallel.decode_attn.block_decode_attention`); both run without
autograd, on each rank's blocks.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.basic import normal_param, rope_apply
from repro_torch.parallel.ax import (
    block,
    gathered,
    local_map,
    local_offset,
    merge_heads,
    mesh_shape,
    redistribute,
    rows_view,
    shard_groups,
    split_heads,
    wrap,
)
from repro_torch.parallel.decode_attn import block_decode_attention

NEG_INF = -1e30


class Attention(nn.Module):
    """The projections ``wq`` (D, H*HD), ``wk``/``wv`` (D, KVH*HD), ``wo``
    (H*HD, D), and the biases when ``cfg.qkv_bias``."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator=None,
                 d_model: int | None = None):
        super().__init__()
        d = d_model or cfg.d_model
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.wq = normal_param((d, h * hd), d, dtype, device, generator)
        self.wk = normal_param((d, kvh * hd), d, dtype, device, generator)
        self.wv = normal_param((d, kvh * hd), d, dtype, device, generator)
        self.wo = normal_param((h * hd, d), h * hd, dtype, device, generator)
        if cfg.qkv_bias:
            for name, n in (("bq", h * hd), ("bk", kvh * hd),
                            ("bv", kvh * hd)):
                setattr(self, name, nn.Parameter(
                    torch.zeros(n, dtype=dtype, device=device),
                    requires_grad=False))


def qkv_proj(attn: Attention, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, rope: bool = True):
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    q = x @ gathered(attn.wq)
    k = x @ gathered(attn.wk)
    v = x @ gathered(attn.wv)
    if cfg.qkv_bias:
        q, k, v = q + attn.bq, k + attn.bk, v + attn.bv
    q, k, v = split_heads(q, h), split_heads(k, kvh), split_heads(v, kvh)
    if rope:
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)
    return q, k, v


# ------------------------------------------------------------------ naive ---


def attention_naive(q, k, v, causal: bool, q_offset: int = 0):
    """q: (B,Sq,H,Dqk), k: (B,Skv,KVH,Dqk), v: (B,Skv,KVH,Dv)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.reshape(b, sq, kvh, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / math.sqrt(d)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(skv, device=q.device)[None, :]
        s = torch.where((qpos >= kpos)[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


# ---------------------------------------------------------- chunked flash ---


def _flash_qchunk(qc, k, v, q_pos0: int, kv_chunk: int, causal: bool):
    """Online softmax for one Q chunk over all KV chunks.

    qc: (B, QC, KVH, G, D) float32, pre-scaled; k/v: (B, Skv, KVH, D).
    Returns (B, QC, KVH, G, Dv) float32."""
    b, qcn, kvh, g, _ = qc.shape
    nkv = k.shape[1] // kv_chunk
    dv = v.shape[-1]
    dev = qc.device
    m = torch.full((b, kvh, g, qcn), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g, qcn), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, qcn, dv), dtype=torch.float32, device=dev)
    qpos = q_pos0 + torch.arange(qcn, device=dev)
    for kvi in range(nkv):
        sl = slice(kvi * kv_chunk, (kvi + 1) * kv_chunk)
        ki, vi = k[:, sl].float(), v[:, sl].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc, ki)
        if causal:
            kpos = kvi * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.where((qpos[:, None] >= kpos[None, :])[None, None, None],
                            s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vi)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B,KVH,G,QC,Dv)
    return out.permute(0, 3, 1, 2, 4)                   # (B,QC,KVH,G,Dv)


def flash_attention(q, k, v, causal: bool = True, q_chunk: int = 1024,
                    kv_chunk: int = 1024, block_skip: bool = True):
    """Chunked online-softmax attention. q: (B,Sq,H,Dqk), k: (B,Skv,KVH,Dqk),
    v: (B,Skv,KVH,Dv) — Dv may differ from Dqk (MLA).  With ``block_skip``
    and a causal square problem each Q chunk reads only its causally
    visible KV prefix."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    if sq % q_chunk or skv % kv_chunk:
        return attention_naive(q, k, v, causal)
    nq = sq // q_chunk
    qs = q.reshape(b, nq, q_chunk, kvh, g, d).float() / math.sqrt(d)
    skip = block_skip and causal and sq == skv
    outs = []
    for qi in range(nq):
        end = (qi + 1) * q_chunk if skip else skv
        outs.append(_flash_qchunk(qs[:, qi], k[:, :end], v[:, :end],
                                  qi * q_chunk, kv_chunk, causal))
    out = torch.stack(outs, dim=1)                      # (B,nq,QC,KVH,G,Dv)
    return out.reshape(b, sq, h, dv).to(q.dtype)


# ----------------------------------------------------------------- decode ---


def decode_attention(q, k_cache, v_cache, length):
    """Single-token decode against a dense cache (the serve path's oracle).

    q: (B,1,H,D); caches: (B,S,KVH,D); length: (B,) valid prefix lengths.
    The products take the caches' values in float32 (the JAX function's
    ``preferred_element_type``), the softmax is float32."""
    b, _, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    qf = q.reshape(b, kvh, g, d).to(k_cache.dtype).float()
    sc = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float()) / math.sqrt(d)
    mask = torch.arange(s, device=q.device)[None, :] < length[:, None]
    sc = torch.where(mask[:, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)


# ------------------------------------------------------------ full blocks ---


def attend(cfg: ModelConfig, q, k, v, causal: bool = True):
    """Attention over a whole sequence: the naive softmax up to
    ``cfg.flash_threshold`` query tokens, the chunked flash past it."""
    if isinstance(q, DTensor):
        return _attend_sharded(cfg, q, k, v, causal)
    if q.shape[1] > cfg.flash_threshold:
        return flash_attention(q, k, v, causal=causal,
                               q_chunk=cfg.attn_chunk, kv_chunk=cfg.attn_chunk)
    return attention_naive(q, k, v, causal=causal)


def _attend_sharded(cfg: ModelConfig, q, k, v, causal: bool, fn=None):
    """``fn`` (`attend` by default) on each rank's block: rows as the
    batch lies; the query heads on the mesh dimension that shards them
    where they split there (one dimension at most), with the KV heads
    they read: sharded alike where the KV heads split too, else cut
    from every KV head where each rank's query heads fall in whole
    groups or inside one; every head elsewhere."""
    mesh = q.device_mesh
    fn = fn or (lambda q, k, v: attend(cfg, q, k, v, causal))
    h, kvh = q.shape[2], k.shape[2]
    g = h // kvh
    qv, kv = [], []
    cut = None
    for d, (p, n) in enumerate(zip(q.placements, mesh_shape(mesh))):
        hq = h // n
        if p == Shard(0):
            qv.append(p)
            kv.append(p)
        elif p == Shard(2) and h % n == 0 and cut is None and (
                kvh % n == 0 or hq % g == 0 or g % hq == 0):
            qv.append(p)
            if kvh % n == 0:
                kv.append(p)
                cut = ()
            else:
                kv.append(Replicate())
                lo = (mesh.get_local_rank(d) * hq) // g
                cut = (lo, max(hq // g, 1))
        else:
            qv.append(Replicate())
            kv.append(Replicate())
    qv, kv = tuple(qv), tuple(kv)

    def local(q, k, v):
        if cut:
            lo, n = cut
            k, v = k[:, :, lo:lo + n], v[:, :, lo:lo + n]
        return fn(q, k, v)

    return local_map(local, mesh, (q, k, v), (qv, kv, kv), qv, qv)


def attn_train(attn: Attention, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """The attention mixer over a whole sequence, no cache."""
    q, k, v = qkv_proj(attn, cfg, x, positions)
    return attn_out(attn, attend(cfg, q, k, v, causal))


def attn_out(attn: Attention, o_bshd: torch.Tensor) -> torch.Tensor:
    return out_product(merge_heads(o_bshd), gathered(attn.wo))


def out_product(o, w):
    """``o @ w``; a DTensor ``o`` (B, S, F) first cut (no communication)
    to the shards of F that ``w`` (F, D) holds, so the product is a
    partial sum over those mesh dimensions."""
    if isinstance(o, DTensor) and isinstance(w, DTensor):
        want = tuple(Shard(2) if wp == Shard(0) else
                     (op if op == Shard(0) else Replicate())
                     for op, wp in zip(o.placements, w.placements))
        o = redistribute(o, want)
    return o @ w


# ---------------------------------------------- caches sharded by length ---


def _layer_block(cache, layer):
    """(this rank's block, the placements and the global shape) of a cache
    DTensor, or of its ``layer``-th entry (a leading layer axis, which
    must not be sharded) when ``layer`` is not None."""
    loc, pl, shape = cache._local_tensor, tuple(cache.placements), \
        tuple(cache.shape)
    if layer is None:
        return loc, pl, shape
    if any(p == Shard(0) for p in pl):
        raise ValueError("a cache's layer axis is sharded")
    pl = tuple(Shard(p.dim - 1) if p.is_shard() else p for p in pl)
    return loc[layer], pl, shape[1:]


def fill_block(cache, new, layer=None) -> None:
    """Write ``new`` (a DTensor (B, T, ...)) into positions [0, T) of a
    cache sharded along dimension 1, each rank its block's part, in
    place."""
    loc, pl, shape = _layer_block(cache, layer)
    mesh = cache.device_mesh
    nb = block(new, rows_view(pl))
    off, s_loc = local_offset(mesh, pl, 1, shape[1])
    cnt = max(0, min(nb.shape[1] - off, s_loc))
    if cnt:
        loc[:, :cnt] = nb[:, off:off + cnt].to(loc.dtype)


def masked_write(cache: torch.Tensor, new: torch.Tensor, pos, off: int):
    """``cache[r, pos[r] - off] = new[r]`` for the rows whose position falls
    in this block of positions [off, off + S_loc), in place; the other
    rows keep their values (a read and a write of one position a row)."""
    s_loc = cache.shape[1]
    rel = pos.long() - off
    hit = (rel >= 0) & (rel < s_loc)
    relc = rel.clamp(0, s_loc - 1)
    rows = torch.arange(cache.shape[0], device=cache.device)
    old = cache[rows, relc]
    hit = hit.reshape(-1, *([1] * (new.ndim - 1)))
    cache[rows, relc] = torch.where(hit, new.to(cache.dtype), old)


def row_slice(mesh, pl, n_rows: int, t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of ``t`` (every rank's same whole value) under the
    row placements of ``pl``."""
    r0, nb = local_offset(mesh, rows_view(pl), 0, n_rows)
    return t[r0:r0 + nb]


def decode_sharded(q, k_new, v_new, k_cache, v_cache, length, layer=None):
    """One decode step's attention over caches sharded along their length
    (DTensors (B, S, KVH, HD), or L-stacked with ``layer``): ``k_new`` /
    ``v_new`` (B, 1, KVH, HD) written at ``length`` (B,) by
    `masked_write` on each rank's block, then every head of q (B, 1, H,
    HD) attends to positions 0..length by split-K over the ranks holding
    the blocks.  With ``k_new`` None nothing is written and q attends to
    the whole cache (cross-attention).  Returns (B, 1, H, HD), rows laid
    out as the cache's, every head on every rank."""
    mesh = q.device_mesh
    kb, pl, shape = _layer_block(k_cache, layer)
    vb, _, _ = _layer_block(v_cache, layer)
    rows = rows_view(pl)
    qb = block(q, rows)
    off, _ = local_offset(mesh, pl, 1, shape[1])
    if k_new is None:
        lens = torch.full((qb.shape[0],), shape[1], dtype=torch.long,
                          device=qb.device)
    else:
        ln = row_slice(mesh, pl, shape[0], length.long())
        masked_write(kb, block(k_new, rows)[:, 0], ln, off)
        masked_write(vb, block(v_new, rows)[:, 0], ln, off)
        lens = ln + 1
    o = block_decode_attention(qb, kb, vb, lens, off,
                               shard_groups(mesh, pl, 1))
    return wrap(o, mesh, rows, (shape[0],) + tuple(q.shape[1:]))
