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

Sharded (DTensor activations, `repro_torch.parallel`): the heads lie on
"model" (``wq_b`` / ``wq`` / ``wkv_b`` shard their columns by head,
``wo`` its rows).  The query latent comes from ``wq_a`` gathered whole
(its RMS norm reads every column) and the KV latents from ``wkv_a``
(replicated on "model"), so every rank computes them once.  Training and
prefill attend over each rank's heads (`parallel.ax.local_map`); the
absorbed decode writes the new latent into the rank's block of the
length-sharded caches (`attention.masked_write`), gathers the absorbed
queries of every head over "model", and merges the blocks' partial
softmaxes by split-K (`parallel.decode_attn.merge_partials`), each rank
then taking its heads through ``W_uv`` and ``wo``: a partial sum over
"model".  Heads that do not split over "model" are every rank's.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.layers.attention import (
    NEG_INF,
    flash_attention,
    masked_write,
    out_product,
    row_slice,
)
from repro_torch.models.layers.basic import RMSNorm, normal_param, rope_apply
from repro_torch.parallel.ax import (
    block,
    constrain,
    gathered,
    head_view,
    local_map,
    local_offset,
    merge_heads,
    redistribute_local,
    rows_view,
    shard_groups,
    split_heads,
    whole,
    wrap,
)
from repro_torch.parallel.decode_attn import merge_partials


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
    h, qn = cfg.num_heads, cfg.qk_nope_dim
    if cfg.q_lora_rank > 0:
        q = _latent(mla.q_norm(x @ whole(mla.wq_a))) @ gathered(mla.wq_b)
    else:
        q = x @ gathered(mla.wq)
    q = split_heads(q, h)
    return q[..., :qn], rope_apply(q[..., qn:], positions, cfg.rope_theta)


def _latent(t):
    """A latent every rank holds whole, its gradient (a partial sum over
    the head axes: the up-projections it feeds shard the heads) reduced
    here, before the RMS norm's backward reads it (`parallel.ax.constrain`:
    DTensor's rules would reduce it themselves); a no-op unsharded."""
    return constrain(t, "batch", "seq", None)


def _latents(mla: MLA, cfg: ModelConfig, x, positions):
    """(c_kv (B,S,kvl) normed, k_rope (B,S,qr) with RoPE applied)."""
    kvl = cfg.kv_lora_rank
    kv = x @ gathered(mla.wkv_a)
    c_kv = _latent(mla.kv_norm(kv[..., :kvl]))
    return c_kv, rope_apply(kv[..., kvl:], positions, cfg.rope_theta)


def mla_train(mla: MLA, cfg: ModelConfig, x, positions, causal: bool = True):
    """Training / prefill form.  Up to ``cfg.flash_threshold`` tokens the
    materialised S x S softmax; past it the shared RoPE key is broadcast to
    every head (q' = [q_nope | q_rope], k' = [k_nope | k_rope]) and the
    chunked flash attention runs with q/k width qn + qr, v width vh."""
    qn = cfg.qk_nope_dim
    q_nope, q_rope = _queries(mla, cfg, x, positions)
    c_kv, k_rope = _latents(mla, cfg, x, positions)
    kvb = split_heads(c_kv @ gathered(mla.wkv_b), cfg.num_heads)
    k_nope, v = kvb[..., :qn], kvb[..., qn:]
    o = _attend(cfg, q_nope, q_rope, k_nope, k_rope, v, causal)
    return out_product(merge_heads(o), gathered(mla.wo))


def _attend(cfg: ModelConfig, q_nope, q_rope, k_nope, k_rope, v,
            causal: bool):
    """`_attend_local` on each rank's rows and heads (the heads as
    ``q_nope``'s lie; ``k_rope`` has none)."""
    if not isinstance(q_nope, DTensor):
        return _attend_local(cfg, q_nope, q_rope, k_nope, k_rope, v, causal)
    hv = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
               for p in q_nope.placements)
    rows = rows_view(hv)

    def local(qn_, qr_, kn_, kr_, v_):
        return _attend_local(cfg, qn_, qr_, kn_, kr_, v_, causal)

    return local_map(local, q_nope.device_mesh,
                     (q_nope, q_rope, k_nope, k_rope, v),
                     (hv, hv, hv, rows, hv), hv, hv)


def _attend_local(cfg: ModelConfig, q_nope, q_rope, k_nope, k_rope, v,
                  causal: bool):
    """Attention (B,S,H,vh) in the activation dtype: up to
    ``cfg.flash_threshold`` tokens the materialised softmax, past it the
    chunked flash with the shared RoPE key broadcast to every head."""
    b, s, h, qn = q_nope.shape
    qr = q_rope.shape[-1]
    if s > cfg.flash_threshold:
        qq = torch.cat([q_nope, q_rope], dim=-1)              # (B,S,H,qn+qr)
        kk = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, qr)],
                       dim=-1)
        return flash_attention(qq, kk, v, causal=causal,
                               q_chunk=cfg.attn_chunk,
                               kv_chunk=cfg.attn_chunk)
    scale = 1.0 / math.sqrt(qn + qr)
    sc = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
          + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), k_rope.float())
          ) * scale
    if causal:
        ar = torch.arange(s, device=q_nope.device)
        sc = torch.where((ar[:, None] >= ar[None, :])[None, None], sc,
                         NEG_INF)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q_nope.dtype)


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
    if isinstance(x, DTensor):
        return (_decode_sharded(mla, cfg, x, positions, ckv_cache,
                                krope_cache, length), ckv_cache, krope_cache)
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


def _decode_sharded(mla: MLA, cfg: ModelConfig, x, positions, ckv_cache,
                    krope_cache, length):
    """`mla_decode` over caches sharded along their length (the module's
    docstring); returns y (B,1,D), a partial sum over the head axes."""
    h, qn, qr, vh = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    kvl = cfg.kv_lora_rank
    mesh = x.device_mesh
    q_nope, q_rope = _queries(mla, cfg, x, positions)        # (B,1,H,*)
    c_kv_new, k_rope_new = _latents(mla, cfg, x, positions)
    cb, kb = ckv_cache._local_tensor, krope_cache._local_tensor
    pl, shape = tuple(ckv_cache.placements), tuple(ckv_cache.shape)
    rows = rows_view(pl)
    off, _ = local_offset(mesh, pl, 1, shape[1])
    ln = row_slice(mesh, pl, shape[0], length.long())
    masked_write(cb, block(c_kv_new, rows)[:, 0], ln, off)
    masked_write(kb, block(k_rope_new, rows)[:, 0], ln, off)

    # this rank's heads: the absorbed queries, then every head's over "model"
    heads = head_view(q_nope.placements, 2, 1)
    lo, hn = local_offset(mesh, heads, 1, h)
    w = block(mla.wkv_b, heads).reshape(kvl, hn, qn + vh)
    w_uk, w_uv = w[..., :qn].float(), w[..., qn:].float()
    q4 = tuple(r if r == Shard(0) else p
               for r, p in zip(rows, head_view(q_nope.placements, 2, 2)))
    q_lat = torch.einsum("bhd,rhd->bhr", block(q_nope, q4)[:, 0].float(),
                         w_uk)
    q3 = tuple(r if r == Shard(0) else p for r, p in zip(rows, heads))
    q_lat = redistribute_local(q_lat, mesh, q3, rows)        # (b,H,kvl)
    q_rope = block(q_rope, rows)[:, 0].float()               # (b,H,qr)

    scale = 1.0 / math.sqrt(qn + qr)
    ckv = cb.float()
    sc = (torch.einsum("bhr,bsr->bhs", q_lat, ckv)
          + torch.einsum("bhd,bsd->bhs", q_rope, kb.float())) * scale
    pos = off + torch.arange(cb.shape[1], device=cb.device)
    sc = torch.where((pos[None] <= ln[:, None])[:, None], sc, NEG_INF)
    m = torch.amax(sc, dim=-1)                               # (b,H)
    p = torch.exp(sc - m[..., None])
    o_lat = merge_partials(m, p.sum(-1), torch.einsum("bhs,bsr->bhr", p, ckv),
                           shard_groups(mesh, pl, 1))        # (b,H,kvl)
    o = torch.einsum("bhr,rhd->bhd", o_lat[:, lo:lo + hn], w_uv)
    o = o.reshape(o.shape[0], 1, hn * vh).to(x.dtype)
    y = o @ block(mla.wo, head_view(q_nope.placements, 2, 0))
    out = tuple(Partial() if hp.is_shard() else r
                for r, hp in zip(rows, heads))
    return wrap(y, mesh, out, (shape[0], 1, x.shape[2]))

