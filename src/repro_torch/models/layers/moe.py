"""Mixture-of-Experts FFN: shared experts + routed top-k with sort-based,
capacity-bounded dispatch (port of ``repro.models.layers.moe``).

The JAX function is plain ``jnp`` (einsums, ``argsort``, ``searchsorted``
and scatters, no Pallas kernel), so it stays plain PyTorch here: the
grouped expert GEMM is one ``torch.bmm`` over the (E, C, D) expert batch.

Sharded (DTensor activations, `repro_torch.parallel`), `moe_apply` runs
by hand (`parallel.ax.local_map`): every rank routes and dispatches all
the tokens (their rows gathered over "data"), so capacity and drops are
the unsharded ones; it runs its own experts ("expert" on "model", each
expert's weights gathered over "data") on its share of their capacity
slots ("expert_cap" on "data", JAX's ``constrain`` at the same site,
less the data axes that do not divide the slots), and
the combined rows are summed over the mesh back to the batch's layout.
With top-2 a token's sum is still ``0 + a + b``, exact in any order.

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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.basic import SwiGLU, mlp_apply, normal_param
from repro_torch.parallel.ax import (
    DATA_AXES,
    constrain,
    local_map,
    local_offset,
)


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
    return _route(moe.router, cfg, xf)


def _route(router: torch.Tensor, cfg: ModelConfig, xf: torch.Tensor):
    logits = xf.float() @ router
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


def slots(cfg: ModelConfig, n_tokens: int) -> int:
    """The capacity slots an expert gets (`Dispatch.c`) when `dispatch`
    takes ``n_tokens`` tokens."""
    tk = n_tokens * cfg.moe_top_k
    blocks = max(cfg.moe_dispatch_blocks, 1)
    if blocks > 1 and tk % blocks == 0:
        per = tk // blocks
        return blocks * max(8, -(-math.ceil(per / cfg.moe_experts
                                            * cfg.capacity_factor) // 8) * 8)
    return capacity(cfg, n_tokens)


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
    if isinstance(x, DTensor):
        return _moe_sharded(moe, cfg, x)
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gates, idx = route(moe, cfg, xf)
    dp = dispatch(cfg, gates, idx)
    out = _experts(xf, dp.slot_token, dp.slot_gate, moe.w_gate, moe.w_up,
                   moe.w_down)
    if hasattr(moe, "shared"):
        out = out + mlp_apply(moe.shared, xf)
    return out.reshape(b, s, d)


def _experts(xf, slot_token, slot_gate, w_gate, w_up, w_down):
    """The tokens ``xf`` (T, D) through the experts of ``w_gate`` /
    ``w_up`` (E, D, F) and ``w_down`` (E, F, D) in their slots
    (``slot_token`` (E * C,), -1 empty), each output weighted by its
    slot's gate and scatter-added to its token's row: (T, D)."""
    t, d = xf.shape
    e = w_gate.shape[0]
    valid = slot_token >= 0
    tok = torch.clamp(slot_token, min=0)
    zero = torch.zeros((), dtype=xf.dtype, device=xf.device)
    xg = torch.where(valid[:, None], xf[tok], zero).reshape(e, -1, d)

    # grouped expert GEMM
    g = torch.bmm(xg, w_gate)
    u = torch.bmm(xg, w_up)
    h = torch.nn.functional.silu(g.float()).to(xf.dtype) * u
    y = torch.bmm(h, w_down).reshape(-1, d)

    # weighted combine (scatter-add) in the activation dtype
    contrib = y * slot_gate[:, None].to(y.dtype)
    return torch.zeros((t, d), dtype=xf.dtype, device=xf.device).index_add_(
        0, tok, torch.where(valid[:, None], contrib, zero))


def _moe_sharded(moe: MoE, cfg: ModelConfig, x: DTensor) -> DTensor:
    """`moe_apply` on a DTensor (B, S, D): see the module's docstring."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    whole = (Replicate(),) * mesh.ndim
    w_view = tuple(p if p == Shard(0) else Replicate()
                   for p in moe.w_gate.placements)
    c, prod, cap = slots(cfg, x.shape[0] * x.shape[1]), 1, []
    for k in range(mesh.ndim):       # the data axes that divide the slots
        n = mesh.size(k)
        ok = (names[k] in DATA_AXES and w_view[k] != Shard(0)
              and c % (prod * n) == 0)
        cap.append(Shard(1) if ok else Replicate())
        prod *= n if ok else 1
    cap = tuple(cap)
    out_view = tuple(Partial() if w_view[k] == Shard(0) or cap[k] == Shard(1)
                     else Replicate() for k in range(mesh.ndim))
    e_lo, e_n = local_offset(mesh, w_view, 0, cfg.moe_experts)

    def local(xl, router, w_gate, w_up, w_down):
        b, s, d = xl.shape
        xf = xl.reshape(b * s, d)
        gates, idx = _route(router, cfg, xf)
        dp = dispatch(cfg, gates, idx)
        c_lo, c_n = local_offset(mesh, cap, 1, dp.c)
        sl = (slice(e_lo, e_lo + e_n), slice(c_lo, c_lo + c_n))
        out = _experts(xf, dp.slot_token.reshape(-1, dp.c)[sl].reshape(-1),
                       dp.slot_gate.reshape(-1, dp.c)[sl].reshape(-1),
                       w_gate, w_up, w_down)
        return out.reshape(b, s, d)

    out = local_map(local, mesh, (x, moe.router, moe.w_gate, moe.w_up,
                                  moe.w_down),
                    (whole, whole, w_view, w_view, w_view), out_view,
                    x.placements)
    if hasattr(moe, "shared"):
        out = out + constrain(mlp_apply(moe.shared, x), "batch", "seq",
                              "embed")
    return out


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
