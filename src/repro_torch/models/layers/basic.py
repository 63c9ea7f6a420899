"""Basic layers: RMSNorm, RoPE, the SwiGLU MLP, embeddings (port of
``repro.models.layers.basic``).

The functions take tensors (the norm math in float32, the products in the
activation dtype), as the JAX functions take parameter dicts; the modules
(`RMSNorm`, `SwiGLU`, `Embedding`) hold the parameters under the JAX
package's names, so a JAX parameter tree maps onto ``state_dict`` keys
one to one (`repro_torch.models.weights`).

Sharded (a DTensor parameter, `repro_torch.parallel`): each product reads
its weight through `parallel.ax.gathered` (FSDP's all-gather over
"data"), and the vocab-sharded embedding lookup is written by hand
(`embed_apply`).  A plain tensor takes the same code as before.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.parallel.ax import gathered, like, local_map, local_offset

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name (``cfg.dtype``)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def normal_param(shape, fan_in: int, dtype: torch.dtype, device,
                 generator: torch.Generator | None) -> nn.Parameter:
    """A weight drawn as in ``basic._normal``: standard normal in float32
    over sqrt(fan_in), cast to ``dtype``; ``generator`` None leaves it
    uninitialized (to be loaded)."""
    if generator is None:
        w = torch.empty(shape, dtype=dtype, device=device)
    else:
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        w = w.div_(math.sqrt(fan_in)).to(dtype)
    return nn.Parameter(w, requires_grad=False)


def const_param(shape, value: float, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device),
                        requires_grad=False)


# ----------------------------------------------------------------- norms ---


def rmsnorm_apply(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = const_param((d,), 1.0, dtype, device)

    def forward(self, x):
        return rmsnorm_apply(self.scale, x, self.eps)


# ------------------------------------------------------------------ RoPE ---


def rope_apply(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S).  The
    frequencies are computed in float32 exactly as the JAX function does."""
    d = x.shape[-1]
    half = d // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    # a Python-float base: a tensor made from ``theta`` on the card would
    # be a host-to-device copy, which waits for the stream on every call
    freq = 1.0 / (float(theta) ** (ar / half))
    ang = positions.float()[..., None] * freq          # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.ndim == positions.ndim + 2:                    # broadcast over heads
        cos, sin = cos[..., None, :], sin[..., None, :]
    cos, sin = like(cos, x), like(sin, x)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- MLP ---


def mlp_apply(ffn: "SwiGLU", x: torch.Tensor) -> torch.Tensor:
    """SwiGLU (LLaMA-style)."""
    g = x @ gathered(ffn.w_gate)
    u = x @ gathered(ffn.w_up)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ gathered(ffn.w_down)


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype, device,
                 generator=None):
        super().__init__()
        self.w_gate = normal_param((d_model, d_ff), d_model, dtype, device,
                                   generator)
        self.w_up = normal_param((d_model, d_ff), d_model, dtype, device,
                                 generator)
        self.w_down = normal_param((d_ff, d_model), d_ff, dtype, device,
                                   generator)

    def forward(self, x):
        return mlp_apply(self, x)


# ------------------------------------------------------------- embedding ---


class Embedding(nn.Module):
    """Token table ``tok`` (V, D); an untied output head ``head`` (D, V)
    unless ``tie``."""

    def __init__(self, vocab: int, d_model: int, dtype, device, tie=False,
                 generator=None):
        super().__init__()
        self.tok = normal_param((vocab, d_model), d_model, dtype, device,
                                generator)
        if not tie:
            self.head = normal_param((d_model, vocab), d_model, dtype,
                                     device, generator)


def embed_apply(embed: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(embed.tok, DTensor):
        return _sharded_lookup(embed.tok, tokens)
    return embed.tok[tokens]


def _sharded_lookup(tok: DTensor, tokens) -> DTensor:
    """``tok[tokens]`` for a table sharded (V on "model", D on "data"):
    the table's D gathered, each rank looks the ids up in its vocab rows
    (the others read zero) and the rows are summed over the vocab axes;
    ids (B, S) keep their rows' layout, the output (B, S, D) too."""
    mesh = tok.device_mesh
    tab_view = tuple(p if p == Shard(0) else Replicate()
                     for p in tok.placements)
    tokens = like(torch.as_tensor(tokens, device=tok.device), tok)
    ids_view = tuple(Replicate() if t == Shard(0) or p != Shard(0) else p
                     for p, t in zip(tokens.placements, tab_view))
    out_view = tuple(Partial() if t == Shard(0) else i
                     for t, i in zip(tab_view, ids_view))
    out = tuple(Replicate() if p.is_partial() else p for p in out_view)
    off, n = local_offset(mesh, tab_view, 0, tok.shape[0])

    def lookup(tab, ids):
        rel = ids.long() - off
        hit = (rel >= 0) & (rel < n)
        rows = tab[rel.clamp(0, n - 1)]
        zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
        return torch.where(hit[..., None], rows, zero)

    return local_map(lookup, mesh, (tok, tokens), (tab_view, ids_view),
                     out_view, out)


def logits_apply(embed: Embedding, x: torch.Tensor,
                 softcap: float = 0.0) -> torch.Tensor:
    if hasattr(embed, "head"):
        logits = x @ gathered(embed.head)
    else:
        logits = x @ gathered(embed.tok).t()
    logits = logits.float()
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
