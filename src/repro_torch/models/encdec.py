"""Encoder-decoder backbone (Whisper-style, the audio family; port of
``repro.models.encdec``).

The conv frontend is a stub, as in the JAX package: the caller passes
precomputed frame embeddings (B, T_enc, d_model).  The encoder is a
bidirectional transformer over them; the decoder adds cross-attention.
RoPE gives positions in the encoder and the decoder's self-attention (in
place of Whisper's learned embeddings, as the JAX package does); the cross
query and keys take none.

Caches are stacked over the decoder layers, as JAX's are: ``k`` / ``v``
(L, B, max_len, KVH, HD) for self-attention, written in place at each step,
and ``ck`` / ``cv`` (L, B, T_enc, KVH, HD) for cross-attention, computed
once by the prefill.  As in `transformer`, ``forward_train`` and
``loss_fn`` keep autograd; with ``cfg.remat`` and autograd on, each
encoder and each decoder layer is checkpointed (keeping only its inputs,
whatever ``remat_policy`` says, as JAX's ``nothing_saveable`` does
here).  ``unroll`` has no effect.

Sharded (parameters by ``shard_params``, the batch and caches by
``batch_spec`` / ``cache_specs``, under `parallel.ax.logical_rules`):
the encoder, self- and cross-attention run as the decoder blocks' do,
with `parallel.ax.constrain` on each norm's and each sub-layer's output;
the caches ``k`` / ``v`` and ``ck`` / ``cv`` are sharded along their
length on "model" (where it splits), the prefill writing each rank's
block (`attention.fill_block`) and the decode attending over the blocks
by split-K (`attention.decode_sharded`), the cross-attention over every
encoder position.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.core.deltatree import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.attention import (
    Attention,
    _attend_sharded,
    attend,
    attention_naive,
    attn_out,
    attn_train,
    decode_attention,
    decode_sharded,
    fill_block,
    qkv_proj,
)
from repro_torch.models.layers.basic import (
    Embedding,
    RMSNorm,
    SwiGLU,
    dtype_of,
    mlp_apply,
)
from repro_torch.models.transformer import (
    LanguageModel,
    _generator,
    remat,
    xent,
)
from repro_torch.parallel.ax import constrain, gathered, split_heads

_BSE = ("batch", "seq", "embed")


class EncoderLayer(nn.Module):
    """``norm1``, ``attn``, ``norm2``, ``mlp`` — the JAX names."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator=None):
        super().__init__()
        d = cfg.d_model
        self.norm1 = RMSNorm(d, dtype, device, cfg.norm_eps)
        self.attn = Attention(cfg, dtype, device, generator)
        self.norm2 = RMSNorm(d, dtype, device, cfg.norm_eps)
        self.mlp = SwiGLU(d, cfg.d_ff, dtype, device, generator)


class DecoderLayer(nn.Module):
    """``norm1``, ``self_attn``, ``norm_x``, ``cross_attn``, ``norm2``,
    ``mlp`` — the JAX names."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator=None):
        super().__init__()
        d = cfg.d_model
        self.norm1 = RMSNorm(d, dtype, device, cfg.norm_eps)
        self.self_attn = Attention(cfg, dtype, device, generator)
        self.norm_x = RMSNorm(d, dtype, device, cfg.norm_eps)
        self.cross_attn = Attention(cfg, dtype, device, generator)
        self.norm2 = RMSNorm(d, dtype, device, cfg.norm_eps)
        self.mlp = SwiGLU(d, cfg.d_ff, dtype, device, generator)


def _cross_kv(attn: Attention, cfg: ModelConfig, enc_out):
    """Cross-attention K/V (B, T_enc, KVH, HD) of the encoder output."""
    k = enc_out @ gathered(attn.wk)
    v = enc_out @ gathered(attn.wv)
    if cfg.qkv_bias:
        k, v = k + attn.bk, v + attn.bv
    return split_heads(k, cfg.num_kv_heads), split_heads(v, cfg.num_kv_heads)


def _cross_q(attn: Attention, cfg: ModelConfig, x):
    q = x @ gathered(attn.wq)
    if cfg.qkv_bias:
        q = q + attn.bq
    return split_heads(q, cfg.num_heads)


def _naive_bidirectional(q, k, v):
    return attention_naive(q, k, v, causal=False)


def _cross_attn(attn: Attention, cfg: ModelConfig, x, k, v):
    q = _cross_q(attn, cfg, x)
    if isinstance(q, DTensor):
        o = _attend_sharded(cfg, q, k, v, False, fn=_naive_bidirectional)
    else:
        o = attention_naive(q, k, v, causal=False)
    return attn_out(attn, o)


def _sub(x, y):
    """x plus a sub-layer's output, both constrained (no-ops unsharded)."""
    return constrain(x + constrain(y, *_BSE), *_BSE)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> dict:
    """Zero L-stacked caches in ``cfg.dtype``: ``k`` / ``v`` (L, B,
    max_len, KVH, HD), ``ck`` / ``cv`` (L, B, encoder_seq, KVH, HD)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    l, kvh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

    def zeros(t):
        return torch.zeros((l, batch, t, kvh, hd), dtype=dtype, device=dev)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "ck": zeros(cfg.encoder_seq), "cv": zeros(cfg.encoder_seq)}


class EncDec(LanguageModel):
    """``embed`` (an untied output head, as the JAX ``init_params`` makes
    it), ``encoder`` / ``decoder`` (lists of layers), ``enc_norm``,
    ``final_norm``.  ``generator`` / ``seed`` / ``init`` as
    `transformer.Transformer`'s."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 generator: torch.Generator | None = None,
                 init: bool = True):
        super().__init__()
        if cfg.family != "audio":
            raise ValueError(f"EncDec runs the audio family, not "
                             f"{cfg.family!r} (models.transformer)")
        cfg.validate()
        dev = resolve_device(device)
        generator = _generator(dev, seed, generator, init)
        pdt = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, pdt, dev,
                               generator=generator)
        self.encoder = nn.ModuleList(
            EncoderLayer(cfg, pdt, dev, generator)
            for _ in range(cfg.encoder_layers))
        self.enc_norm = RMSNorm(cfg.d_model, pdt, dev, cfg.norm_eps)
        self.decoder = nn.ModuleList(
            DecoderLayer(cfg, pdt, dev, generator)
            for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, pdt, dev, cfg.norm_eps)

    def init_caches(self, batch: int, max_len: int) -> dict:
        return init_caches(self.cfg, batch, max_len, self.device)

    def encode(self, frames) -> torch.Tensor:
        """frames (B, T_enc, D) stub embeddings -> the encoder output."""
        cfg = self.cfg
        if not isinstance(frames, DTensor):
            frames = torch.as_tensor(frames, device=self.device)
        x = constrain(frames.to(self.act_dtype), *_BSE)
        b, t, _ = x.shape
        positions = self._positions(b, t)

        def layer_fn(lp, x):
            x = _sub(x, attn_train(lp.attn, cfg, constrain(lp.norm1(x), *_BSE),
                                   positions, causal=False))
            return _sub(x, mlp_apply(lp.mlp, constrain(lp.norm2(x), *_BSE)))

        on = cfg.remat and torch.is_grad_enabled()
        for lp in self.encoder:
            x = remat("nothing", layer_fn, lp, x) if on else layer_fn(lp, x)
        return self.enc_norm(x)

    def _cross_and_mlp(self, lp: DecoderLayer, x, ck, cv, layer=None):
        """Cross-attention to ``ck`` / ``cv`` (the decode's L-stacked
        sharded caches at ``layer`` where it is not None), then the MLP."""
        if layer is None:
            x = _sub(x, _cross_attn(lp.cross_attn, self.cfg,
                                    constrain(lp.norm_x(x), *_BSE), ck, cv))
        else:
            q = _cross_q(lp.cross_attn, self.cfg,
                         constrain(lp.norm_x(x), *_BSE))
            o = decode_sharded(q, None, None, ck, cv, None, layer=layer)
            x = _sub(x, attn_out(lp.cross_attn, o))
        return _sub(x, mlp_apply(lp.mlp, constrain(lp.norm2(x), *_BSE)))

    # --------------------------------------------------------- training ---

    def forward_train(self, tokens, frames) -> torch.Tensor:
        """tokens (B, S), frames (B, T_enc, D) -> logits (B, S, V)."""
        cfg = self.cfg
        enc_out = self.encode(frames)
        x = constrain(self._embed(tokens), *_BSE)
        positions = self._positions(*x.shape[:2])

        def layer_fn(lp, x, enc_out):
            x = _sub(x, attn_train(lp.self_attn, cfg,
                                   constrain(lp.norm1(x), *_BSE), positions,
                                   causal=True))
            ck, cv = _cross_kv(lp.cross_attn, cfg, enc_out)
            return self._cross_and_mlp(lp, x, ck, cv)

        on = cfg.remat and torch.is_grad_enabled()
        for lp in self.decoder:
            x = (remat("nothing", layer_fn, lp, x, enc_out) if on
                 else layer_fn(lp, x, enc_out))
        return self._logits(x)

    def loss_fn(self, batch: dict) -> torch.Tensor:
        """Next-token cross entropy. batch: {tokens, labels, frames}."""
        logits = self.forward_train(batch["tokens"], batch["frames"])
        return xent(logits, torch.as_tensor(batch["labels"],
                                            device=self.device))

    # ---------------------------------------------------------- serving ---

    @torch.no_grad()
    def prefill(self, tokens, frames, caches: dict):
        """Encode ``frames``, run the prompt (B, S), fill ``k`` / ``v`` in
        [0, S) and ``ck`` / ``cv`` whole, in place.  Returns (logits (B,
        1, V) at the last position, caches)."""
        enc_out = self.encode(frames)
        if enc_out.shape[1] != caches["ck"].shape[2]:
            raise ValueError(f"{enc_out.shape[1]} frames, but the caches "
                             f"hold {caches['ck'].shape[2]}")
        cfg = self.cfg
        x = constrain(self._embed(tokens), *_BSE)
        s = x.shape[1]
        positions = self._positions(x.shape[0], s)
        sharded = isinstance(x, DTensor)
        for li, lp in enumerate(self.decoder):
            q, k, v = qkv_proj(lp.self_attn, cfg,
                               constrain(lp.norm1(x), *_BSE), positions)
            x = _sub(x, attn_out(lp.self_attn, attend(cfg, q, k, v)))
            ck, cv = _cross_kv(lp.cross_attn, cfg, enc_out)
            x = self._cross_and_mlp(lp, x, ck, cv)
            if sharded:
                for name, t in (("k", k), ("v", v), ("ck", ck), ("cv", cv)):
                    fill_block(caches[name], t, layer=li)
                continue
            caches["k"][li, :, :s] = k.to(caches["k"].dtype)
            caches["v"][li, :, :s] = v.to(caches["v"].dtype)
            caches["ck"][li] = ck.to(caches["ck"].dtype)
            caches["cv"][li] = cv.to(caches["cv"].dtype)
        return self._logits(x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, token, caches: dict, length):
        """token (B, 1), length (B,) cached tokens -> (logits (B, 1, V),
        caches with the new K/V at ``length``)."""
        cfg = self.cfg
        length = torch.as_tensor(length, device=self.device)
        x = self._embed(token)
        positions = length[:, None].to(torch.int32)
        rows = torch.arange(x.shape[0], device=self.device)
        ln = length.long()
        for li, lp in enumerate(self.decoder):
            q, k, v = qkv_proj(lp.self_attn, cfg,
                               constrain(lp.norm1(x), *_BSE), positions)
            if isinstance(x, DTensor):
                o = decode_sharded(q, k, v, caches["k"], caches["v"], ln,
                                   layer=li)
                x = _sub(x, attn_out(lp.self_attn, o))
                x = self._cross_and_mlp(lp, x, caches["ck"], caches["cv"],
                                        layer=li)
                continue
            kc, vc = caches["k"][li], caches["v"][li]
            kc[rows, ln] = k[:, 0].to(kc.dtype)
            vc[rows, ln] = v[:, 0].to(vc.dtype)
            o = decode_attention(q, kc, vc, ln + 1)
            x = x + attn_out(lp.self_attn, o)
            x = self._cross_and_mlp(lp, x, caches["ck"][li],
                                    caches["cv"][li])
        return self._logits(x), caches
