"""Mixture-of-Experts FFN: shared experts + routed top-k with sort-based,
capacity-bounded dispatch (port of ``repro.models.layers.moe``).

The JAX function is plain ``jnp`` (einsums, ``argsort``, ``searchsorted``
and scatters, no Pallas kernel), so it stays plain PyTorch here: the
grouped expert GEMM is one ``torch.bmm`` over the (E, C, D) expert batch.
JAX's ``constrain`` is a sharding hint and has no counterpart on one card.

Which (token, expert) pairs run and which drop equals JAX bit for bit:

- top-k takes the k largest router probabilities, the lower expert id
  first on a tie (``jax.lax.top_k``'s order; ``torch.topk`` promises no
  order, so a stable descending sort is cut to k);
- pairs are grouped by expert with a stable argsort, ranked inside their
  expert with ``searchsorted(side="left")``, and a rank at or past the
  capacity goes to the drop slot ``E * C``, which is sliced off (JAX's
  ``.at[...].set(mode="drop")`` over an array one longer);
- block-local dispatch (``moe_dispatch_blocks > 1``) ranks within each
  block of ``T * K / blocks`` pairs and lays each expert's capacity out
  block-major.

Casts follow JAX: router logits in float32, ``silu(g.float()).to(act) *
u``, and the weighted combine a scatter-add in the activation dtype into
zeros.  With top-2 and no shared expert a token's sum is ``0 + a + b``,
exact in either order; with k > 2 the order of the adds could round
differently from XLA's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.basic import SwiGLU, mlp_apply, normal_param


class MoE(nn.Module):
    """``router`` (D, E) in float32 whatever ``param_dtype`` is (as
    ``init_moe`` makes it), ``w_gate`` / ``w_up`` (E, D, F), ``w_down``
    (E, F, D), and ``shared`` (a `SwiGLU` of width ``moe_d_ff *
    moe_shared``) when ``moe_shared > 0`` — the JAX parameter names."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator=None):
        super().__init__()
        d, e, f = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
        self.router = normal_param((d, e), d, torch.float32, device,
                                   generator)
        self.w_gate = normal_param((e, d, f), d, dtype, device, generator)
        self.w_up = normal_param((e, d, f), d, dtype, device, generator)
        self.w_down = normal_param((e, f, d), f, dtype, device, generator)
        if cfg.moe_shared > 0:
            self.shared = SwiGLU(d, f * cfg.moe_shared, dtype, device,
                                 generator)


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert gets for ``n_tokens`` tokens under global dispatch:
    ceil(T K / E x capacity_factor), at least 8, rounded up to 8."""
    c = math.ceil(n_tokens * cfg.moe_top_k / cfg.moe_experts
                  * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(moe: MoE, cfg: ModelConfig, xf: torch.Tensor):
    """(gates (T, K) float32 renormalised over the k chosen, expert ids
    (T, K) int64) of tokens ``xf`` (T, D)."""
    logits = xf.float() @ moe.router
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :cfg.moe_top_k], idx[:, :cfg.moe_top_k]
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), idx


class Dispatch(NamedTuple):
    """The expert batch's layout: ``slot_token`` (E*C,) the token in each
    slot (-1 empty), ``slot_gate`` (E*C,) its gate, ``kept`` (T, K) whether
    each (token, choice) pair got a slot, ``c`` the slots an expert."""

    slot_token: torch.Tensor
    slot_gate: torch.Tensor
    kept: torch.Tensor
    c: int


def dispatch(cfg: ModelConfig, gates: torch.Tensor,
             idx: torch.Tensor) -> Dispatch:
    """Sort-based dispatch of the (T, K) choices ``idx`` into E experts'
    capacity slots, globally or block-locally, as the JAX function."""
    t, k = idx.shape
    e = cfg.moe_experts
    dev = idx.device
    tk = t * k
    flat_e = idx.reshape(tk)
    blocks = max(cfg.moe_dispatch_blocks, 1)
    if blocks > 1 and tk % blocks == 0:
        per = tk // blocks
        c_blk = max(8, -(-math.ceil(per / e * cfg.capacity_factor) // 8) * 8)
        c = blocks * c_blk
        e2 = flat_e.reshape(blocks, per)
        order_b = torch.argsort(e2, dim=1, stable=True)
        sorted_e = torch.gather(e2, 1, order_b)
        rank = (torch.arange(per, device=dev)[None]
                - torch.searchsorted(sorted_e, sorted_e, side="left"))
        keep = rank < c_blk
        cap_idx = torch.arange(blocks, device=dev)[:, None] * c_blk + rank
        dest = torch.where(keep, sorted_e * c + cap_idx, e * c).reshape(-1)
        order = (order_b
                 + torch.arange(blocks, device=dev)[:, None] * per).reshape(-1)
        keep = keep.reshape(-1)
    else:
        c = capacity(cfg, t)
        order = torch.argsort(flat_e, stable=True)      # group by expert
        sorted_e = flat_e[order]
        rank = (torch.arange(tk, device=dev)
                - torch.searchsorted(sorted_e, sorted_e, side="left"))
        keep = rank < c
        dest = torch.where(keep, sorted_e * c + rank, e * c)  # overflow drop
    # one slot past the end takes every dropped pair, then is cut off
    slot_token = torch.full((e * c + 1,), -1, dtype=torch.int64, device=dev)
    slot_token[dest] = order // k
    slot_gate = torch.zeros(e * c + 1, dtype=torch.float32, device=dev)
    slot_gate[dest] = gates.reshape(tk)[order]
    kept = torch.zeros(tk, dtype=torch.bool, device=dev)
    kept[order] = keep
    return Dispatch(slot_token[:e * c], slot_gate[:e * c], kept.reshape(t, k),
                    c)


def moe_apply(moe: MoE, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    e = cfg.moe_experts
    t = b * s
    xf = x.reshape(t, d)
    gates, idx = route(moe, cfg, xf)
    dp = dispatch(cfg, gates, idx)
    valid = dp.slot_token >= 0
    tok = torch.clamp(dp.slot_token, min=0)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xg = torch.where(valid[:, None], xf[tok], zero).reshape(e, dp.c, d)

    # grouped expert GEMM
    g = torch.bmm(xg, moe.w_gate)
    u = torch.bmm(xg, moe.w_up)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    y = torch.bmm(h, moe.w_down).reshape(e * dp.c, d)

    # weighted combine (scatter-add) in the activation dtype
    contrib = y * dp.slot_gate[:, None].to(y.dtype)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device).index_add_(
        0, tok, torch.where(valid[:, None], contrib, zero))
    if hasattr(moe, "shared"):
        out = out + mlp_apply(moe.shared, xf)
    return out.reshape(b, s, d)


def moe_ref(moe: MoE, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Dense oracle: every expert on every token, no capacity (tests
    only)."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    gates, idx = route(moe, cfg, xf)
    g = torch.einsum("td,edf->tef", xf, moe.w_gate)
    u = torch.einsum("td,edf->tef", xf, moe.w_up)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    y_all = torch.einsum("tef,efd->ted", h, moe.w_down)      # (T, E, D)
    sel = y_all[torch.arange(t, device=x.device)[:, None], idx]  # (T, K, D)
    out = torch.einsum("tkd,tk->td", sel.float(), gates).to(x.dtype)
    if hasattr(moe, "shared"):
        out = out + mlp_apply(moe.shared, xf)
    return out.reshape(b, s, d)
