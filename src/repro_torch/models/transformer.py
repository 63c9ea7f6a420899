"""Decoder-only LM (port of ``repro.models.transformer``: the dense, MoE
and VLM families).

``Transformer`` holds the embedding, one `blocks.Block` per layer in an
``nn.ModuleList`` and the final norm, under the JAX parameter names (the
JAX package's scan-stacked ``slots`` become the list; `weights` carries a
JAX tree over).  Entry points, as in the JAX module:

  init_caches(batch, max_len)         -> dense per-layer K/V caches
  prefill(tokens, caches[, vision_embeds]) -> (last-position logits, caches)
  decode_step(token, caches, length)  -> (logits, caches)

VLM family: ``vision_embeds`` (B, vision_tokens, D), precomputed patch
embeddings (the JAX package's frontend stub), go in front of the token
embeddings, as ``_embed_inputs`` puts them; a VLM prefill without them
raises where the JAX function asserts.

Caches are written in place (the JAX functions return new ones).  Weights
are made on ``device`` (``cuda`` unless the caller names the CPU) from an
explicit ``torch.Generator``, with the JAX initializer's fan-in scaling.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.deltatree import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.basic import (
    Embedding,
    RMSNorm,
    dtype_of,
    embed_apply,
    logits_apply,
)


FAMILIES = ("dense", "moe", "vlm")   # the rest raise (ROADMAP.md, Queue 1)


def _layout(cfg: ModelConfig):
    """(n_prologue, period, reps): prologue layers are applied unscanned in
    the JAX package; the rest are stacked over the layer pattern."""
    period = cfg.pattern_period
    n_pro = cfg.dense_layers
    if (cfg.num_layers - n_pro) % period:
        raise ValueError(f"{cfg.num_layers} layers do not tile prologue "
                         f"{n_pro} + period {period}")
    return n_pro, period, (cfg.num_layers - n_pro) // period


class Transformer(nn.Module):
    """The decoder.  ``generator`` draws every weight (a new one
    seeded with ``seed`` on ``device`` when None); ``init=False`` leaves
    the weights uninitialized for `weights.load_state`."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 generator: torch.Generator | None = None,
                 init: bool = True):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"the {cfg.family!r} family is not ported to repro_torch "
                f"yet; see ROADMAP.md, Queue 1")
        cfg.validate()
        _layout(cfg)
        dev = resolve_device(device)
        if not init:
            generator = None
        elif generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        pdt = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, pdt, dev,
                               tie=cfg.tie_embeddings, generator=generator)
        self.layers = nn.ModuleList(
            B.Block(cfg, i, pdt, dev, generator)
            for i in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, pdt, dev, cfg.norm_eps)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    @property
    def act_dtype(self) -> torch.dtype:
        return dtype_of(self.cfg.dtype)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # ------------------------------------------------------------ cache ---

    def init_caches(self, batch: int, max_len: int) -> list[dict]:
        """One zero ``{"k", "v"}`` (B, max_len, KVH, HD) cache per layer."""
        return [B.init_block_cache(self.cfg, batch, max_len, self.act_dtype,
                                   self.device)
                for _ in range(self.cfg.num_layers)]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_apply(self.embed, tokens).to(self.act_dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        return logits_apply(self.embed, x, self.cfg.logits_softcap)

    # --------------------------------------------------------- forward ---

    @torch.no_grad()
    def prefill(self, tokens, caches: list[dict], vision_embeds=None):
        """tokens (B, S) -> (logits (B, 1, V) float32 at the last position,
        caches filled in [0, S)); a VLM's ``vision_embeds`` (B, V_tok, D)
        go in front, so its caches fill [0, V_tok + S)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        x = self._embed(tokens)
        if self.cfg.family == "vlm":
            if vision_embeds is None:
                raise ValueError(
                    f"{self.cfg.name}: a vlm prefill needs vision_embeds "
                    f"(B, {self.cfg.vision_tokens}, {self.cfg.d_model}) "
                    f"in front of the tokens; none were given")
            ve = torch.as_tensor(vision_embeds, device=self.device)
            x = torch.cat([ve.to(x.dtype), x], dim=1)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device)[None].expand(b, s)
        for layer, cache in zip(self.layers, caches):
            x, _ = B.block_prefill(layer, self.cfg, x, positions, cache)
        return self._logits(x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, token, caches: list[dict], length):
        """token (B, 1) int32, length (B,) cached tokens -> (logits (B, 1,
        V) float32, caches with the new K/V at ``length``)."""
        token = torch.as_tensor(token, device=self.device)
        length = torch.as_tensor(length, device=self.device)
        x = self._embed(token)
        positions = length[:, None].to(torch.int32)
        for layer, cache in zip(self.layers, caches):
            x, _ = B.block_decode(layer, self.cfg, x, positions, cache,
                                  length.long())
        return self._logits(x), caches
