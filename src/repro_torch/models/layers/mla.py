"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434; port of
``repro.models.layers.mla``).

KV is compressed to a per-token latent ``c_kv`` (kv_lora_rank) plus one
shared RoPE key (qk_rope_dim).  Decode caches only (c_kv, k_rope) — 576
elements a token at DeepSeek-V2 width — and absorbs the up-projection into
the query and output paths (the "weight absorption" trick), so decode
attention runs in latent space.

The JAX functions are plain ``jnp`` einsums, no Pallas kernel, so these are
plain PyTorch: products through ``matmul`` / ``einsum``, scores and softmax
in float32 as there.  Decode writes the new latent into the caches in place
(the JAX function scatters into new arrays).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.attention import NEG_INF, flash_attention
from repro_torch.models.layers.basic import RMSNorm, normal_param, rope_apply


class MLA(nn.Module):
    """``wkv_a`` (D, kvl + qr), ``kv_norm``, ``wkv_b`` (kvl, H (qn + vh)),
    ``wo`` (H vh, D), and the queries through ``wq_a`` / ``q_norm`` /
    ``wq_b`` when ``cfg.q_lora_rank > 0``, else ``wq`` (D, H (qn + qr)) —
    the JAX parameter names."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator=None):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        qn, qr, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        kvl, ql = cfg.kv_lora_rank, cfg.q_lora_rank
        self.wkv_a = normal_param((d, kvl + qr), d, dtype, device, generator)
        self.kv_norm = RMSNorm(kvl, dtype, device, cfg.norm_eps)
        self.wkv_b = normal_param((kvl, h * (qn + vh)), kvl, dtype, device,
                                  generator)
        self.wo = normal_param((h * vh, d), h * vh, dtype, device, generator)
        if ql > 0:
            self.wq_a = normal_param((d, ql), d, dtype, device, generator)
            self.q_norm = RMSNorm(ql, dtype, device, cfg.norm_eps)
            self.wq_b = normal_param((ql, h * (qn + qr)), ql, dtype, device,
                                     generator)
        else:
            self.wq = normal_param((d, h * (qn + qr)), d, dtype, device,
                                   generator)


def _queries(mla: MLA, cfg: ModelConfig, x, positions):
    """(q_nope (B,S,H,qn), q_rope (B,S,H,qr) with RoPE applied)."""
    b, s, _ = x.shape
    h, qn, qr = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank > 0:
        q = mla.q_norm(x @ mla.wq_a) @ mla.wq_b
    else:
        q = x @ mla.wq
    q = q.reshape(b, s, h, qn + qr)
    return q[..., :qn], rope_apply(q[..., qn:], positions, cfg.rope_theta)


def _latents(mla: MLA, cfg: ModelConfig, x, positions):
    """(c_kv (B,S,kvl) normed, k_rope (B,S,qr) with RoPE applied)."""
    kvl = cfg.kv_lora_rank
    kv = x @ mla.wkv_a
    c_kv = mla.kv_norm(kv[..., :kvl])
    return c_kv, rope_apply(kv[..., kvl:], positions, cfg.rope_theta)


def mla_train(mla: MLA, cfg: ModelConfig, x, positions, causal: bool = True):
    """Training / prefill form.  Up to ``cfg.flash_threshold`` tokens the
    materialised S x S softmax; past it the shared RoPE key is broadcast to
    every head (q' = [q_nope | q_rope], k' = [k_nope | k_rope]) and the
    chunked flash attention runs with q/k width qn + qr, v width vh."""
    b, s, _ = x.shape
    h, qn, qr, vh = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _queries(mla, cfg, x, positions)
    c_kv, k_rope = _latents(mla, cfg, x, positions)
    kvb = (c_kv @ mla.wkv_b).reshape(b, s, h, qn + vh)
    k_nope, v = kvb[..., :qn], kvb[..., qn:]

    if s > cfg.flash_threshold:
        qq = torch.cat([q_nope, q_rope], dim=-1)              # (B,S,H,qn+qr)
        kk = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, qr)],
                       dim=-1)
        o = flash_attention(qq, kk, v, causal=causal,
                            q_chunk=cfg.attn_chunk, kv_chunk=cfg.attn_chunk)
        return o.reshape(b, s, h * vh) @ mla.wo

    scale = 1.0 / math.sqrt(qn + qr)
    sc = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
          + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), k_rope.float())
          ) * scale
    if causal:
        ar = torch.arange(s, device=x.device)
        sc = torch.where((ar[:, None] >= ar[None, :])[None, None], sc,
                         NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.reshape(b, s, h * vh).to(x.dtype) @ mla.wo


def mla_prefill(mla: MLA, cfg: ModelConfig, x, positions):
    """Prefill: (output, c_kv (B,S,kvl), k_rope (B,S,qr)) — the latent
    cache of the prompt."""
    y = mla_train(mla, cfg, x, positions, causal=True)
    c_kv, k_rope = _latents(mla, cfg, x, positions)
    return y, c_kv, k_rope


def mla_decode(mla: MLA, cfg: ModelConfig, x, positions, ckv_cache,
               krope_cache, length):
    """Absorbed decode: attention entirely in latent space.

    x: (B,1,D); caches: (B,S,kvl), (B,S,qr), this token's latents written
    at ``length`` (B,) in place; it attends to positions 0..length (itself
    included).  Returns (y, ckv_cache, krope_cache)."""
    b = x.shape[0]
    h, qn, qr, vh = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    kvl = cfg.kv_lora_rank
    smax = ckv_cache.shape[1]

    q_nope, q_rope = _queries(mla, cfg, x, positions)         # (B,1,H,*)
    c_kv_new, k_rope_new = _latents(mla, cfg, x, positions)
    rows = torch.arange(b, device=x.device)
    ckv_cache[rows, length] = c_kv_new[:, 0].to(ckv_cache.dtype)
    krope_cache[rows, length] = k_rope_new[:, 0].to(krope_cache.dtype)

    wkv_b = mla.wkv_b.reshape(kvl, h, qn + vh)
    w_uk = wkv_b[..., :qn].float()                            # (kvl, H, qn)
    w_uv = wkv_b[..., qn:].float()                            # (kvl, H, vh)
    ckv = ckv_cache.float()

    # absorb W_uk into the query: q_lat (B,H,kvl)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk)
    scale = 1.0 / math.sqrt(qn + qr)
    sc = (torch.einsum("bhr,bsr->bhs", q_lat, ckv)
          + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                         krope_cache.float())) * scale
    mask = torch.arange(smax, device=x.device)[None] <= length[:, None]
    sc = torch.where(mask[:, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", p, ckv)
    o = torch.einsum("bhr,rhd->bhd", o_lat, w_uv)
    y = o.reshape(b, 1, h * vh).to(x.dtype) @ mla.wo
    return y, ckv_cache, krope_cache
