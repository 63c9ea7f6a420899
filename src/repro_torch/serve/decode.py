"""Model-side decode machinery shared by every serve loop (port of
``repro.serve.decode``).

Dense prefill with K/V scatter into allocated pages, and the single paged
decode step: per layer, write the new token's K/V into each sequence's
tail page slot, then run the CUDA paged decode-attention kernel
(`repro_torch.kernels.delta_paged_attention`) over the block table.

The JAX functions write the page tensors functionally (``.at[].set``) and
return new ones; here the (L, NP, PS, KVH, HD) page tensors are written in
place (``index_copy_`` / ``index_put_``) and returned as they came — a
copy per layer would move the whole cache (GBs at Granite width) per step.
No pager, no queue, no index here: the scheduler owns *which* lanes
decode; this module owns *how* a lane's tokens turn into logits.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.delta_paged_attention import paged_decode_attention
from repro_torch.models.blocks import ffn_residual
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.attention import attn_out, qkv_proj
from repro_torch.models.layers.basic import embed_apply, logits_apply
from repro_torch.models.transformer import Transformer


def layer_params(cfg: ModelConfig, model: Transformer) -> list:
    """The per-layer blocks, in layer order."""
    return list(model.layers)


@torch.no_grad()
def prefill_to_pages(cfg: ModelConfig, model: Transformer, page_size: int,
                     k_pages, v_pages, prompt, pages):
    """Dense prefill of one prompt, K/V copied into ``pages`` in place.

    Returns (k_pages, v_pages, seq_len, first_token): the first decoded
    token is the argmax over the prompt's last logit.  A VLM raises here,
    as the JAX function's prefill asserts: no vision embeddings reach it."""
    toks = torch.as_tensor(prompt, dtype=torch.int32,
                           device=model.device)[None]
    s = toks.shape[1]
    n = len(pages)
    caches = model.init_caches(1, n * page_size)
    logits, caches = model.prefill(toks, caches)
    idx = torch.as_tensor(pages, dtype=torch.long, device=k_pages.device)
    shape = (n, page_size, cfg.num_kv_heads, cfg.head_dim)
    for li, c in enumerate(caches):
        k_pages[li].index_copy_(0, idx, c["k"][0].reshape(shape))
        v_pages[li].index_copy_(0, idx, c["v"][0].reshape(shape))
    return k_pages, v_pages, s, int(torch.argmax(logits[0, -1]))


def _check_tail(tail_page: torch.Tensor) -> None:
    """The growth pass maps every tail page before the decode, so a -1
    there is a pager fault (the JAX path would wrap it to the last page).
    Checked on the device without a sync on the card."""
    ok = (tail_page >= 0).all()
    if tail_page.device.type == "cuda":
        torch._assert_async(ok)
    elif not bool(ok):
        raise RuntimeError("paged_decode_step: a lane's tail page is unmapped")


@torch.no_grad()
def paged_decode_step(model: Transformer, cfg: ModelConfig, layers, tokens,
                      k_pages, v_pages, block_tables, lengths,
                      page_size: int):
    """One decode step over paged caches.

    tokens (B, 1) int32, block_tables (B, MAXP) int32, lengths (B,) int32
    tokens already cached, all on the model's device.  Returns (logits
    (B, 1, V) float32, k_pages, v_pages) with each lane's new K/V written
    at position ``lengths`` of its tail page."""
    act = k_pages.dtype
    x = embed_apply(model.embed, tokens).to(act)
    positions = lengths[:, None].to(torch.int32)
    b = tokens.shape[0]
    rows = torch.arange(b, device=tokens.device)
    ln = lengths.long()
    tail_page = block_tables[rows, ln // page_size].long()
    _check_tail(tail_page)
    tail_off = ln % page_size
    seq_lens = (lengths + 1).to(torch.int32)
    for li, layer in enumerate(layers):
        h = layer.norm1(x)
        q, k, v = qkv_proj(layer.mixer, cfg, h, positions)
        k_pages[li][tail_page, tail_off] = k[:, 0].to(act)
        v_pages[li][tail_page, tail_off] = v[:, 0].to(act)
        o = paged_decode_attention(q[:, 0].contiguous(), k_pages[li],
                                   v_pages[li], block_tables, seq_lens)
        x = x + attn_out(layer.mixer, o[:, None])
        x = ffn_residual(layer, cfg, x)       # the MLP, or the MoE FFN
    x = model.final_norm(x)
    logits = logits_apply(model.embed, x, cfg.logits_softcap)
    return logits, k_pages, v_pages
