"""Per-layer blocks: pre-norm GQA attention + an FFN (SwiGLU MLP or MoE)
with residuals (port of ``repro.models.blocks``).

The JAX package's MLA and SSD (Mamba2) mixers are not ported yet; a config
that needs one raises `NotImplementedError` (ROADMAP.md, Queue 1 item 7).
Caches are per-layer dicts ``{"k", "v"}`` of shape (B, S, KVH, HD),
written in place.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.attention import (
    Attention,
    attention_naive,
    attn_out,
    decode_attention,
    flash_attention,
    qkv_proj,
)
from repro_torch.models.layers.basic import RMSNorm, SwiGLU, mlp_apply
from repro_torch.models.layers.moe import MoE, moe_apply


def block_kinds(cfg: ModelConfig, i: int) -> tuple[str, str]:
    return cfg.layer_kind(i), cfg.ffn_kind(i)


def _has_ffn(cfg: ModelConfig, ffn_kind: str) -> bool:
    return ffn_kind == "moe" or cfg.d_ff > 0


def check_kinds(cfg: ModelConfig, i: int) -> None:
    """Raise for a layer whose kind the port has no counterpart of yet."""
    if cfg.mla or cfg.layer_kind(i) != "attn":
        kind = "MLA" if cfg.mla else "SSD"
        raise NotImplementedError(
            f"{kind} layers (layer {i} of {cfg.name}) are not ported to "
            f"repro_torch yet; see ROADMAP.md, Queue 1")


class Block(nn.Module):
    """One layer: ``norm1``, ``mixer`` (GQA attention), ``norm2``, ``ffn``
    (SwiGLU, or `MoE` where ``cfg.ffn_kind(i)`` says so) — the JAX
    parameter names."""

    def __init__(self, cfg: ModelConfig, layer_idx: int, dtype, device,
                 generator=None):
        super().__init__()
        check_kinds(cfg, layer_idx)
        self.kinds = block_kinds(cfg, layer_idx)
        self.norm1 = RMSNorm(cfg.d_model, dtype, device, cfg.norm_eps)
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
        h = layer.norm2(x)
        x = x + (moe_apply(layer.ffn, cfg, h) if layer.kinds[1] == "moe"
                 else mlp_apply(layer.ffn, h))
    return x


def init_block_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device) -> dict:
    """Zero dense cache for one attention block."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def block_prefill(layer: Block, cfg: ModelConfig, x, positions, cache):
    """Run the block over a full prompt, filling ``cache`` in [0, S) in
    place.  Returns (x, cache)."""
    s = x.shape[1]
    h = layer.norm1(x)
    q, k, v = qkv_proj(layer.mixer, cfg, h, positions)
    if s > cfg.flash_threshold:
        o = flash_attention(q, k, v, causal=True, q_chunk=cfg.attn_chunk,
                            kv_chunk=cfg.attn_chunk)
    else:
        o = attention_naive(q, k, v, causal=True)
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    x = x + attn_out(layer.mixer, o)
    return ffn_residual(layer, cfg, x), cache


def block_decode(layer: Block, cfg: ModelConfig, x, positions, cache,
                 length):
    """Single-token step. x: (B,1,D); length: (B,) tokens already cached.
    The new K/V go into ``cache`` at ``length`` in place."""
    b = x.shape[0]
    h = layer.norm1(x)
    q, k, v = qkv_proj(layer.mixer, cfg, h, positions)
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, length] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, length] = v[:, 0].to(cache["v"].dtype)
    o = decode_attention(q, cache["k"], cache["v"], length + 1)
    x = x + attn_out(layer.mixer, o)
    return ffn_residual(layer, cfg, x), cache
