"""Decoder-only LM (port of ``repro.models.transformer``): every decoder
family — dense, MoE (DeepSeek-V2's MLA among them), VLM, SSM (Mamba2) and
hybrid (Jamba).

``Transformer`` holds the embedding, one `blocks.Block` per layer in an
``nn.ModuleList`` and the final norm, under the JAX parameter names.  The
JAX package's layout — unscanned prologue layers (DeepSeek-V2's leading
dense-FFN layer), then ``slots`` scan-stacked over the layer pattern's
period (Jamba: 8) — becomes the list, layer ``n_pro + r * period + j``
being slot j at repetition r (`weights` carries a JAX tree over).  Entry
points, as in the JAX module:

  forward_train(tokens[, vision_embeds])     -> logits (B, S_total, V)
  loss_fn(batch)                             -> next-token cross entropy
  init_caches(batch, max_len)                -> per-layer caches by kind
  prefill(tokens, caches[, vision_embeds])   -> (last-position logits, caches)
  decode_step(token, caches, length)         -> (logits, caches)

``forward_train`` and ``loss_fn`` keep autograd (the parameters are made
with ``requires_grad=False``; a trainer turns it on); ``prefill`` and
``decode_step`` run without it.  With ``cfg.remat`` and autograd on,
``forward_train`` checkpoints each repetition of the pattern's slots
(`remat`, the counterpart of ``jax.checkpoint`` on the scan body), and
each layer inside it when the period is more than 1; the prologue layers
are not checkpointed, as in JAX.  The layers are a list, so ``unroll``
(scan unrolling) has no effect here.

VLM family: ``vision_embeds`` (B, vision_tokens, D), precomputed patch
embeddings (the JAX package's frontend stub), go in front of the token
embeddings, as ``_embed_inputs`` puts them; a VLM call without them
raises where the JAX function asserts.

Caches are written in place (the JAX functions return new ones).  Weights
are made on ``device`` (``cuda`` unless the caller names the CPU) from an
explicit ``torch.Generator``, with the JAX initializer's fan-in scaling.

Sharded (parameters placed by `parallel.shardings.shard_params`, the batch
by ``shard_batch``, under `parallel.ax.logical_rules`): the same code runs
on DTensors, `parallel.ax.constrain` at JAX's sites, and `xent` on
vocab-sharded logits is written by hand (`_ShardedXent`).
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils import checkpoint as ckpt

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
from repro_torch.parallel import comm as C
from repro_torch.parallel.ax import (
    axis_of,
    constrain,
    grad_placements,
    like,
    local_offset,
    redistribute_local,
    wrap,
)

# the decoder families; "audio" is the encoder-decoder of `models.encdec`
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")


def _layout(cfg: ModelConfig):
    """(n_prologue, period, reps): prologue layers are applied unscanned in
    the JAX package; the rest are stacked over the layer pattern."""
    period = cfg.pattern_period
    n_pro = cfg.dense_layers
    if (cfg.num_layers - n_pro) % period:
        raise ValueError(f"{cfg.num_layers} layers do not tile prologue "
                         f"{n_pro} + period {period}")
    return n_pro, period, (cfg.num_layers - n_pro) // period


def _slot_kinds(cfg: ModelConfig) -> list:
    """The (mixer, FFN) kinds of each slot of the pattern, which every
    repetition must repeat (the JAX function asserts it)."""
    n_pro, period, reps = _layout(cfg)
    kinds = [B.block_kinds(cfg, n_pro + j) for j in range(period)]
    for j in range(period):
        for r in range(1, reps):
            i = n_pro + r * period + j
            if B.block_kinds(cfg, i) != kinds[j]:
                raise ValueError(f"layer {i} of {cfg.name} breaks the "
                                 f"pattern of slot {j}: {kinds[j]}")
    return kinds


def _save_products(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the weight products' outputs (``x @
    W`` reaches ``aten.mm``; the attention's batched products reach
    ``bmm`` and are recomputed), as ``dots_with_no_batch_dims_saveable``
    keeps JAX's dot products without batch dimensions."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(policy: str, fn, *args):
    """``fn(*args)`` under activation checkpointing, recomputed in the
    backward: ``policy`` "nothing" keeps only the inputs, "dots" also the
    weight products (``cfg.remat_policy``)."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_products)
    elif policy != "nothing":
        raise ValueError(f"unknown remat_policy {policy!r}")
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy over labels >= 0, as the JAX function
    computes it: logsumexp in float32, the label's logit rounded to bf16
    (JAX contracts a bf16 one-hot with the logits cast to bf16)."""
    if isinstance(logits, DTensor):
        return _ShardedXent.apply(logits, labels)
    lse = torch.logsumexp(logits.float(), dim=-1)
    lab = torch.gather(logits.to(torch.bfloat16), -1,
                       labels.clamp(min=0).long()[..., None])[..., 0].float()
    mask = (labels >= 0).float()
    return ((lse - lab) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class _ShardedXent(torch.autograd.Function):
    """`xent` on a DTensor of logits (B, S, V), rows over the data axes
    and the vocab over "model", written by hand: each rank's rows and vocab
    slice, the max and the sum of exponentials all-reduced over the vocab
    axes, the label's logit (bf16, as `xent`) read where the label falls
    and summed over them, the masked mean over the data axes.  Returns the
    replicated 0-d loss.  The backward is softmax minus the label's bf16-
    rounded one-hot, over the valid count."""

    @staticmethod
    def forward(ctx, logits, labels):
        mesh = logits.device_mesh
        view = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
                     for p in logits.placements)
        lg = redistribute_local(logits._local_tensor, mesh, logits.placements,
                                view).float()
        labels = like(torch.as_tensor(labels, device=lg.device), logits)
        rows = tuple(p if p == Shard(0) else Replicate() for p in view)
        lab = redistribute_local(labels._local_tensor, mesh,
                                 labels.placements, rows).long()
        vocab = [axis_of(mesh, k)[2] for k, p in enumerate(view)
                 if p == Shard(2) and mesh.size(k) > 1]
        batch = [axis_of(mesh, k)[2] for k, p in enumerate(view)
                 if p == Shard(0) and mesh.size(k) > 1]
        off, n = local_offset(mesh, view, 2, logits.shape[2])
        m = lg.amax(dim=-1)
        for g in vocab:
            m = C.all_reduce(m, g, "max")
        se = torch.exp(lg - m[..., None]).sum(-1)
        rel = lab.clamp(min=0) - off
        hit = (rel >= 0) & (rel < n)
        idx = rel.clamp(0, n - 1)
        picked = torch.gather(lg.to(torch.bfloat16), -1,
                              idx[..., None])[..., 0].float()
        picked = torch.where(hit, picked, torch.zeros_like(picked))
        both = torch.stack([se, picked])
        for g in vocab:
            both = C.all_reduce(both, g)
        lse = torch.log(both[0]) + m
        mask = (lab >= 0).float()
        tot = torch.stack([((lse - both[1]) * mask).sum(), mask.sum()])
        for g in batch:
            tot = C.all_reduce(tot, g)
        den = torch.clamp(tot[1], min=1.0)
        ctx.save_for_backward(lg, lse, idx, hit, mask, den)
        ctx.mesh, ctx.view = mesh, view
        ctx.src, ctx.shape = tuple(logits.placements), logits.shape
        loss = tot[0] / den
        return wrap(loss, mesh, [Replicate()] * mesh.ndim, ())

    @staticmethod
    def backward(ctx, g):
        lg, lse, idx, hit, mask, den = ctx.saved_tensors
        mesh = ctx.mesh
        g = redistribute_local(g._local_tensor, mesh, g.placements,
                               [Replicate()] * mesh.ndim)
        gt = g * mask / den                                  # (b, s)
        d = torch.exp(lg - lse[..., None]) * gt[..., None]
        lab_g = torch.where(hit, gt, torch.zeros_like(gt))
        lab_g = lab_g.to(torch.bfloat16).float()
        d.scatter_add_(-1, idx[..., None], -lab_g[..., None])
        want = grad_placements(ctx.src)
        d = redistribute_local(d, mesh, ctx.view, want)
        return wrap(d, mesh, want, ctx.shape), None


class LanguageModel(nn.Module):
    """What the decoder and the encoder-decoder share: the embedding
    ``embed`` and ``final_norm`` under the JAX names, the activation dtype,
    the device, and the logits."""

    cfg: ModelConfig

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    @property
    def act_dtype(self) -> torch.dtype:
        return dtype_of(self.cfg.dtype)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def _embed(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.device)
        return embed_apply(self.embed, tokens).to(self.act_dtype)

    def _positions(self, b: int, s: int) -> torch.Tensor:
        return torch.arange(s, dtype=torch.int32,
                            device=self.device)[None].expand(b, s)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = constrain(self.final_norm(x), "batch", "seq", "embed")
        return constrain(logits_apply(self.embed, x, self.cfg.logits_softcap),
                         "batch", "seq", "vocab")


def _generator(device, seed: int, generator, init: bool):
    if not init:
        return None
    if generator is None:
        return torch.Generator(device=device).manual_seed(seed)
    return generator


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> list[dict]:
    """One zero cache per layer, by its kind (`blocks.init_block_cache`),
    in ``cfg.dtype`` (an SSD state in float32)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    return [B.init_block_cache(cfg, B.block_kinds(cfg, i), batch, max_len,
                               dtype, dev)
            for i in range(cfg.num_layers)]


class Transformer(LanguageModel):
    """The decoder.  ``generator`` draws every weight (a new one
    seeded with ``seed`` on ``device`` when None); ``init=False`` leaves
    the weights uninitialized for `weights.load_state`."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 generator: torch.Generator | None = None,
                 init: bool = True):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(
                f"the {cfg.family!r} family is no decoder-only LM; build it "
                f"with models.encdec.EncDec (models.registry.api)")
        cfg.validate()
        _slot_kinds(cfg)
        dev = resolve_device(device)
        generator = _generator(dev, seed, generator, init)
        pdt = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, pdt, dev,
                               tie=cfg.tie_embeddings, generator=generator)
        self.layers = nn.ModuleList(
            B.Block(cfg, i, pdt, dev, generator)
            for i in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, pdt, dev, cfg.norm_eps)

    def init_caches(self, batch: int, max_len: int) -> list[dict]:
        return init_caches(self.cfg, batch, max_len, self.device)

    def _embed_inputs(self, tokens, vision_embeds=None):
        """(x (B, S_total, D), positions (B, S_total)); a VLM's vision
        embeddings go in front of the tokens."""
        x = self._embed(tokens)
        if self.cfg.family == "vlm":
            if vision_embeds is None:
                raise ValueError(
                    f"{self.cfg.name}: a vlm model needs vision_embeds "
                    f"(B, {self.cfg.vision_tokens}, {self.cfg.d_model}) "
                    f"in front of the tokens; none were given")
            ve = torch.as_tensor(vision_embeds, device=self.device)
            x = torch.cat([ve.to(x.dtype), x], dim=1)
        b, s, _ = x.shape
        return constrain(x, "batch", "seq", "embed"), self._positions(b, s)

    # --------------------------------------------------------- training ---

    def forward_train(self, tokens, vision_embeds=None) -> torch.Tensor:
        """tokens (B, S_text) -> logits (B, S_total, V) float32."""
        cfg = self.cfg
        x, positions = self._embed_inputs(tokens, vision_embeds)
        n_pro, period, reps = _layout(cfg)
        on = cfg.remat and torch.is_grad_enabled()

        def layer_fn(layer, x):
            return B.block_train(layer, cfg, x, positions)

        for layer in self.layers[:n_pro]:
            x = layer_fn(layer, x)

        def body(x, *slots):
            for layer in slots:
                # nested per-layer remat bounds the backward's live set to
                # one layer of a multi-layer pattern (JAX's nesting)
                x = (remat(cfg.remat_policy, layer_fn, layer, x)
                     if on and period > 1 else layer_fn(layer, x))
            return x

        for r in range(reps):
            slots = self.layers[n_pro + r * period:n_pro + (r + 1) * period]
            x = (remat(cfg.remat_policy, body, x, *slots) if on
                 else body(x, *slots))
        return self._logits(x)

    def loss_fn(self, batch: dict) -> torch.Tensor:
        """Next-token cross entropy. batch: {tokens, labels[,
        vision_embeds]}; a VLM's vision prefix carries no labels."""
        logits = self.forward_train(batch["tokens"],
                                    batch.get("vision_embeds"))
        labels = torch.as_tensor(batch["labels"], device=self.device)
        if self.cfg.family == "vlm":
            logits = logits[:, -labels.shape[1]:]
        return xent(logits, labels)

    # ---------------------------------------------------------- serving ---

    @torch.no_grad()
    def prefill(self, tokens, caches: list[dict], vision_embeds=None):
        """tokens (B, S) -> (logits (B, 1, V) float32 at the last position,
        caches filled); a VLM's ``vision_embeds`` (B, V_tok, D) go in
        front, so its caches fill [0, V_tok + S)."""
        x, positions = self._embed_inputs(tokens, vision_embeds)
        for layer, cache in zip(self.layers, caches):
            x, _ = B.block_prefill(layer, self.cfg, x, positions, cache)
        return self._logits(x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, token, caches: list[dict], length):
        """token (B, 1) int32, length (B,) cached tokens -> (logits (B, 1,
        V) float32, caches holding the new token)."""
        length = torch.as_tensor(length, device=self.device)
        x = self._embed(token)
        positions = length[:, None].to(torch.int32)
        for layer, cache in zip(self.layers, caches):
            x, _ = B.block_decode(layer, self.cfg, x, positions, cache,
                                  length.long())
        return self._logits(x), caches
