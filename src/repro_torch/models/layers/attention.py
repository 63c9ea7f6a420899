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
heads on "model" where the query and KV head counts both split, else
every head on every rank.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.basic import normal_param, rope_apply
from repro_torch.parallel.ax import gathered, local_map

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
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ gathered(attn.wq)
    k = x @ gathered(attn.wk)
    v = x @ gathered(attn.wv)
    if cfg.qkv_bias:
        q, k, v = q + attn.bq, k + attn.bk, v + attn.bv
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
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


def _attend_sharded(cfg: ModelConfig, q, k, v, causal: bool):
    """`attend` on each rank's block: rows as the batch lies, heads on the
    mesh dimensions that shard the query heads where both head counts
    split there, whole elsewhere."""
    mesh = q.device_mesh
    views = []
    for p, n in zip(q.placements, mesh.mesh.shape):
        if p == Shard(0):
            views.append(p)
        elif (p == Shard(2) and q.shape[2] % n == 0
              and k.shape[2] % n == 0):
            views.append(p)
        else:
            views.append(Replicate())
    view = tuple(views)

    def local(q, k, v):
        return attend(cfg, q, k, v, causal)

    return local_map(local, mesh, (q, k, v), (view, view, view), view, view)


def attn_train(attn: Attention, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """The attention mixer over a whole sequence, no cache."""
    q, k, v = qkv_proj(attn, cfg, x, positions)
    return attn_out(attn, attend(cfg, q, k, v, causal))


def attn_out(attn: Attention, o_bshd: torch.Tensor) -> torch.Tensor:
    b, s = o_bshd.shape[:2]
    return o_bshd.reshape(b, s, -1) @ gathered(attn.wo)
