"""Per-layer blocks: a pre-norm mixer (GQA attention, MLA or the SSD of
Mamba2) and an FFN (SwiGLU MLP or MoE), each with its residual (port of
``repro.models.blocks``).

A block's kinds are static, from the config's layer pattern
(``cfg.layer_kind`` / ``cfg.ffn_kind``).  Caches are per-layer dicts,
written in place: ``{"k", "v"}`` (B, S, KVH, HD) for attention,
``{"ckv", "krope"}`` (B, S, kvl) / (B, S, qr) for MLA, ``{"state",
"conv"}`` (B, H, P, N) float32 / (B, w-1, conv_dim) for SSD.

`parallel.ax.constrain` sits at JAX's sites and, sharded, also on each
norm's output and each mixer / FFN output before its residual add (the
edges of the tensor-parallel region, where the gradient / the output is
a partial sum over "model"); without rules every one is a no-op.

Sharded prefill and decode take DTensor activations and caches placed
by ``cache_specs``: an attention or MLA cache is sharded along its
length on "model" and each rank writes its block (`attention.fill_block`,
`attention.decode_sharded`, `mla.mla_decode`), where JAX constrains
the decode's caches to ("batch", "decode_seq"); an SSD cache's state
holds the rank's heads (`mamba2.sharded_step`).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mamba2 as m2
from repro_torch.models.layers.attention import (
    Attention,
    attend,
    attn_out,
    attn_train,
    decode_attention,
    decode_sharded,
    fill_block,
    qkv_proj,
)
from repro_torch.models.layers.basic import RMSNorm, SwiGLU, mlp_apply
from repro_torch.models.layers.mla import (
    MLA,
    mla_decode,
    mla_prefill,
    mla_train,
)
from repro_torch.models.layers.moe import MoE, moe_apply
from repro_torch.parallel.ax import constrain

_BSE = ("batch", "seq", "embed")


def block_kinds(cfg: ModelConfig, i: int) -> tuple[str, str]:
    return cfg.layer_kind(i), cfg.ffn_kind(i)


def _has_ffn(cfg: ModelConfig, ffn_kind: str) -> bool:
    return ffn_kind == "moe" or cfg.d_ff > 0


class Block(nn.Module):
    """One layer: ``norm1``, ``mixer`` (`Attention`, `MLA` when
    ``cfg.mla``, or `Mamba2` where ``cfg.layer_kind(i)`` is "ssm"), and,
    unless the config has no FFN (Mamba2), ``norm2`` and ``ffn`` (SwiGLU,
    or `MoE` where ``cfg.ffn_kind(i)`` says so) — the JAX parameter
    names."""

    def __init__(self, cfg: ModelConfig, layer_idx: int, dtype, device,
                 generator=None):
        super().__init__()
        self.kinds = block_kinds(cfg, layer_idx)
        self.norm1 = RMSNorm(cfg.d_model, dtype, device, cfg.norm_eps)
        if self.kinds[0] == "ssm":
            self.mixer = m2.Mamba2(cfg, dtype, device, generator)
        elif cfg.mla:
            self.mixer = MLA(cfg, dtype, device, generator)
        else:
            self.mixer = Attention(cfg, dtype, device, generator)
        if _has_ffn(cfg, self.kinds[1]):
            self.norm2 = RMSNorm(cfg.d_model, dtype, device, cfg.norm_eps)
            self.ffn = (MoE(cfg, dtype, device, generator)
                        if self.kinds[1] == "moe" else
                        SwiGLU(cfg.d_model, cfg.d_ff, dtype, device,
                               generator))


def ffn_residual(layer: Block, cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    """x plus the layer's FFN of its second norm, where it has one."""
    if hasattr(layer, "ffn"):
        h = constrain(layer.norm2(x), *_BSE)
        y = (moe_apply(layer.ffn, cfg, h) if layer.kinds[1] == "moe"
             else mlp_apply(layer.ffn, h))
        x = x + constrain(y, *_BSE)
    return constrain(x, *_BSE)


# --------------------------------------------------------------- training ---


def block_train(layer: Block, cfg: ModelConfig, x, positions,
                causal: bool = True):
    """The block over a whole sequence, no cache."""
    x = constrain(x, *_BSE)
    h = constrain(layer.norm1(x), *_BSE)
    if layer.kinds[0] == "ssm":
        y = m2.mamba2_train(layer.mixer, cfg, h)
    elif cfg.mla:
        y = mla_train(layer.mixer, cfg, h, positions, causal=causal)
    else:
        y = attn_train(layer.mixer, cfg, h, positions, causal=causal)
    return ffn_residual(layer, cfg, x + constrain(y, *_BSE))


# ---------------------------------------------------------------- caching ---


def init_block_cache(cfg: ModelConfig, kinds, batch: int, max_len: int,
                     dtype, device) -> dict:
    """Zero cache of one block of ``kinds``."""
    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if kinds[0] == "ssm":
        return {"state": zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim,
                               cfg.ssm_state, dt=torch.float32),
                "conv": zeros(batch, cfg.conv_width - 1, m2.conv_dim(cfg))}
    if cfg.mla:
        return {"ckv": zeros(batch, max_len, cfg.kv_lora_rank),
                "krope": zeros(batch, max_len, cfg.qk_rope_dim)}
    return {"k": zeros(batch, max_len, cfg.num_kv_heads, cfg.head_dim),
            "v": zeros(batch, max_len, cfg.num_kv_heads, cfg.head_dim)}


def block_prefill(layer: Block, cfg: ModelConfig, x, positions, cache):
    """Run the block over a full prompt, filling ``cache`` in place (an
    attention or MLA cache in [0, S); an SSD cache's state and conv
    inputs after the prompt).  Returns (x, cache)."""
    s = x.shape[1]
    sharded = isinstance(x, DTensor)
    h = constrain(layer.norm1(x), *_BSE)
    if layer.kinds[0] == "ssm" and sharded:
        y = m2.sharded_step(layer.mixer, cfg, h, cache, decode=False)
    elif layer.kinds[0] == "ssm":
        y, state, conv = m2.mamba2_prefill(layer.mixer, cfg, h)
        cache["state"].copy_(state)
        cache["conv"].copy_(conv)
    elif cfg.mla:
        y, ckv, krope = mla_prefill(layer.mixer, cfg, h, positions)
        if sharded:
            fill_block(cache["ckv"], ckv)
            fill_block(cache["krope"], krope)
        else:
            cache["ckv"][:, :s] = ckv.to(cache["ckv"].dtype)
            cache["krope"][:, :s] = krope.to(cache["krope"].dtype)
    else:
        q, k, v = qkv_proj(layer.mixer, cfg, h, positions)
        if sharded:
            fill_block(cache["k"], k)
            fill_block(cache["v"], v)
        else:
            cache["k"][:, :s] = k.to(cache["k"].dtype)
            cache["v"][:, :s] = v.to(cache["v"].dtype)
        y = attn_out(layer.mixer, attend(cfg, q, k, v))
    return ffn_residual(layer, cfg, x + constrain(y, *_BSE)), cache


def block_decode(layer: Block, cfg: ModelConfig, x, positions, cache,
                 length):
    """Single-token step. x: (B,1,D); length: (B,) tokens already cached.
    Attention and MLA write the new K/V or latent into ``cache`` at
    ``length``; SSD replaces its state and conv inputs; all in place."""
    h = constrain(layer.norm1(x), *_BSE)
    if layer.kinds[0] == "ssm" and isinstance(x, DTensor):
        y = m2.sharded_step(layer.mixer, cfg, h, cache, decode=True)
    elif layer.kinds[0] == "ssm":
        y, state, conv = m2.mamba2_decode(layer.mixer, cfg, h,
                                          cache["state"], cache["conv"])
        cache["state"].copy_(state)
        cache["conv"].copy_(conv)
    elif cfg.mla:
        y, _, _ = mla_decode(layer.mixer, cfg, h, positions, cache["ckv"],
                             cache["krope"], length)
    elif isinstance(x, DTensor):
        # JAX constrains the caches to ("batch", "decode_seq"); here they
        # are laid out so already, and split-K attends over their blocks
        q, k, v = qkv_proj(layer.mixer, cfg, h, positions)
        y = attn_out(layer.mixer, decode_sharded(q, k, v, cache["k"],
                                                 cache["v"], length))
    else:
        q, k, v = qkv_proj(layer.mixer, cfg, h, positions)
        rows = torch.arange(x.shape[0], device=x.device)
        cache["k"][rows, length] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, length] = v[:, 0].to(cache["v"].dtype)
        kc = constrain(cache["k"], "batch", "decode_seq", None, None)
        vc = constrain(cache["v"], "batch", "decode_seq", None, None)
        o = decode_attention(q, kc, vc, length + 1)
        y = attn_out(layer.mixer, o)
    return ffn_residual(layer, cfg, x + constrain(y, *_BSE)), cache
