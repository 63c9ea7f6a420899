"""Mamba-2 / SSD (state-space duality, arXiv:2405.21060; port of
``repro.models.layers.mamba2``).

Chunked SSD: within a chunk the quadratic ("attention-like") dual form,
across chunks the state recurrence, a Python loop over the chunks (the JAX
function's ``lax.scan``).  `ssd_ref` is the sequential recurrence, the
test oracle.  Single-token decode keeps a (B, H, P, N) float32 state and a
(B, w-1, conv_dim) cache of the last w-1 *pre-activation* conv inputs.

Block layout as Mamba-2: in_proj -> [z | x | B | C | dt], causal depthwise
conv over [x | B | C], SiLU, SSD, gated RMSNorm, out_proj.  The JAX
functions are plain ``jnp`` (no Pallas kernel), so these are plain PyTorch
with the same casts: the SSD in float32, the products in the activation
dtype.  ``softplus`` is JAX's ``logaddexp(x, 0)`` (torch's own turns
linear past 20, a different value there).

Sharded (a DTensor ``x``, `repro_torch.parallel`): each rank runs its
heads ("ssm_inner" on "model"): the chunked scan is per head, so it
needs no collective inside.  Its share of the weights (`_Heads`) is cut
from ``w_in`` / ``conv_w`` / ``conv_b`` gathered whole (their "model"
shards are contiguous blocks of columns, which do not follow the
[z | x | B | C | dt] layout; B and C are every head's) and from its rows
of ``w_out``.  Two places communicate: the gated RMS over all of d_inner
(an all-reduce of the sum of squares over the head dimensions,
`parallel.ax.psum`) and the out-projection (a partial sum, reduced where
the block's residual is constrained, as `basic.mlp_apply`'s).  Heads
that do not split over "model" run on every rank.  The caches follow
``cache_specs`` (`sharded_step`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.basic import const_param, normal_param
from repro_torch.parallel.ax import (
    axis_of,
    block,
    local_map,
    local_offset,
    psum,
    redistribute_local,
    rows_view,
    wrap,
)

LOG_EPS = -80.0


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


class Mamba2(nn.Module):
    """``w_in`` (D, 2 di + 2 N + H), ``conv_w`` (w, conv_dim), ``conv_b``,
    ``a_log`` / ``d_skip`` / ``dt_bias`` (H,) in float32 whatever
    ``param_dtype`` is (as ``init_mamba2`` makes them; A = -exp(a_log) =
    -1 at init), ``gate_norm`` (di,), ``w_out`` (di, D) — the JAX
    parameter names."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator=None):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        cd = conv_dim(cfg)
        f32 = torch.float32
        self.w_in = normal_param((d, 2 * di + 2 * n + h), d, dtype, device,
                                 generator)
        self.conv_w = normal_param((cfg.conv_width, cd), cfg.conv_width,
                                   dtype, device, generator)
        self.conv_b = const_param((cd,), 0.0, dtype, device)
        self.a_log = const_param((h,), 0.0, f32, device)
        self.d_skip = const_param((h,), 1.0, f32, device)
        self.dt_bias = const_param((h,), 0.0, f32, device)
        self.gate_norm = const_param((di,), 1.0, dtype, device)
        self.w_out = normal_param((di, d), di, dtype, device, generator)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_in(cfg: ModelConfig, proj, heads: int):
    """(z, [x | B | C], dt) of the input projection of ``heads`` heads."""
    di, n = heads * cfg.ssm_head_dim, cfg.ssm_state
    e = 2 * di + 2 * n
    return proj[..., :di], proj[..., di:e], proj[..., e:]


def _causal_conv(m, xbc, cache=None):
    """Depthwise causal conv over time. xbc: (B,S,C); cache: (B,w-1,C), the
    last w-1 inputs before ``xbc``.  Returns (silu(conv + bias), the last
    w-1 inputs of [cache | xbc]: the next call's cache)."""
    w = m.conv_w.shape[0]
    if cache is None:
        pad = torch.zeros((xbc.shape[0], w - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = cache.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = sum(xp[:, i:i + s, :] * m.conv_w[i][None, None] for i in range(w))
    out = out + m.conv_b
    new_cache = xp[:, -(w - 1):, :] if w > 1 else None
    act = torch.nn.functional.silu(out.float()).to(xbc.dtype)
    return act, new_cache


def _gated_out(m, cfg: ModelConfig, y, z, x_dtype):
    """y * silu(z) -> one RMS over all of d_inner (scaled by ``gate_norm``)
    -> out_proj.  Over a rank's heads (``m.groups``, the ranks holding the
    others) the sum of squares is summed over the groups first."""
    g = y.float() * torch.nn.functional.silu(z.float())
    groups = getattr(m, "groups", ())
    if groups:
        var = psum(torch.sum(g * g, dim=-1, keepdim=True),
                   groups) / cfg.d_inner
    else:
        var = torch.mean(g * g, dim=-1, keepdim=True)
    g = g * torch.rsqrt(var + cfg.norm_eps) * m.gate_norm.float()
    return g.to(x_dtype) @ m.w_out


def _chunk_state_in(t, bc, xc):
    """sum_j t_j B_j x_j^T over a chunk's positions j: (..., H, N, P)."""
    return torch.einsum("...jn,...jhp->...hnp", bc, xc * t[..., None])


def ssd_chunked(cfg: ModelConfig, xh, b_, c_, dt, a_log, d_skip,
                state0=None):
    """Chunked SSD scan.

    xh: (B,S,H,P); b_/c_: (B,S,N); dt: (B,S,H) post-softplus; state0:
    (B,H,P,N) or None.  Returns (y (B,S,H,P) float32, final state
    (B,H,P,N) float32).  The state is held as (B,H,N,P) inside, as the JAX
    function holds it.  A length that is not a chunk multiple is padded
    with dt = 0 (decay 1, no input: the state is exact)."""
    bsz, s0, h, p = xh.shape
    n = b_.shape[-1]
    q = min(cfg.ssm_chunk, s0)
    s = -(-s0 // q) * q
    if s != s0:
        pad = s - s0
        xh = torch.nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
        b_ = torch.nn.functional.pad(b_, (0, 0, 0, pad))
        c_ = torch.nn.functional.pad(c_, (0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    nc = s // q

    a = -torch.exp(a_log)                                  # (H,)
    loga = (dt * a[None, None]).float()                    # (B,S,H) log decay
    xc = xh.reshape(bsz, nc, q, h, p).float()
    bc = b_.reshape(bsz, nc, q, n).float()
    cc = c_.reshape(bsz, nc, q, n).float()
    dtc = dt.reshape(bsz, nc, q, h).float()
    lac = loga.reshape(bsz, nc, q, h)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))

    state = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=xh.device)
             if state0 is None else state0.transpose(2, 3).float())

    if cfg.ssd_vectorized:
        # every chunk at once (the JAX dry-run probes' exact-flop form);
        # only the state recurrence runs chunk by chunk
        lcum = torch.cumsum(lac, dim=2)                    # (B,nc,Q,H)
        ltot = lcum[:, :, -1]
        cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
        ldiff = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]
        decay = torch.exp(torch.where(tri[None, None, :, :, None], ldiff,
                                      LOG_EPS))
        m = cb[..., None] * decay * dtc[:, :, None, :, :]
        y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xc)
        t = torch.exp(lcum[:, :, -1:, :] - lcum) * dtc
        chunk_in = _chunk_state_in(t, bc, xc)              # (B,nc,H,N,P)
        befores = []
        for c in range(nc):
            befores.append(state)
            state = state * torch.exp(ltot[:, c])[:, :, None, None] \
                + chunk_in[:, c]
        s_before = torch.stack(befores, dim=1)             # (B,nc,H,N,P)
        y_inter = torch.einsum("bcin,bchnp->bcihp", cc, s_before) \
            * torch.exp(lcum)[..., None]
        y = y_intra + y_inter
    else:
        ys = []
        for c in range(nc):
            # one chunk: the intra quadratic form plus the inter term from
            # the carried state; the (B,Q,Q,H) tensors live one chunk long
            xck, bck, cck, dtk = xc[:, c], bc[:, c], cc[:, c], dtc[:, c]
            lcum = torch.cumsum(lac[:, c], dim=1)          # (B,Q,H) inclusive
            ltot = lcum[:, -1]                             # (B,H)
            # M[i,j] = (C_i . B_j) exp(L_i - L_j) dt_j, j <= i
            cb = torch.einsum("bin,bjn->bij", cck, bck)
            ldiff = lcum[:, :, None, :] - lcum[:, None, :, :]
            decay = torch.exp(torch.where(tri[None, :, :, None], ldiff,
                                          LOG_EPS))
            m = cb[..., None] * decay * dtk[:, None, :, :]
            y_intra = torch.einsum("bijh,bjhp->bihp", m, xck)
            # inter: C_i . (exp(L_i) S_prev)
            y_inter = torch.einsum("bin,bhnp->bihp", cck, state) \
                * torch.exp(lcum)[..., None]
            t = torch.exp(ltot[:, None] - lcum) * dtk      # (B,Q,H)
            state = state * torch.exp(ltot)[:, :, None, None] \
                + _chunk_state_in(t, bck, xck)
            ys.append(y_intra + y_inter)
        y = torch.stack(ys, dim=1)                         # (B,nc,Q,H,P)
    y = y + d_skip[None, None, :, None] * xc
    y = y.reshape(bsz, s, h, p)[:, :s0]
    return y, state.transpose(2, 3)                        # (B,H,P,N)


def ssd_ref(cfg: ModelConfig, xh, b_, c_, dt, a_log, d_skip):
    """The sequential recurrence, token by token (the test oracle)."""
    bsz, s, h, p = xh.shape
    n = b_.shape[-1]
    a = -torch.exp(a_log)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=xh.device)
    xf, bf, cf, dtf = xh.float(), b_.float(), c_.float(), dt.float()
    ys = []
    for i in range(s):
        decay = torch.exp(dtf[:, i] * a)                   # (B,H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dtf[:, i], bf[:, i], xf[:, i])
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, cf[:, i]))
    return torch.stack(ys, dim=1) + d_skip[None, None, :, None] * xf


def _pre_ssd(m: Mamba2, cfg: ModelConfig, x, conv_cache=None):
    """(z, x heads (B,S,H,P), B (B,S,N), C (B,S,N), dt (B,S,H) float32,
    the conv cache after ``x``)."""
    h = m.dt_bias.shape[0]                                 # its heads
    z, xbc, dt_raw = _split_in(cfg, x @ m.w_in, h)
    xbc, new_conv = _causal_conv(m, xbc, conv_cache)
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    di = h * p
    xin = xbc[..., :di].reshape(*x.shape[:2], h, p)
    b_ = xbc[..., di:di + n]
    c_ = xbc[..., di + n:]
    dt = softplus(dt_raw.float() + m.dt_bias)
    return z, xin, b_, c_, dt, new_conv


def mamba2_train(m: Mamba2, cfg: ModelConfig, x):
    """x: (B,S,D) -> (B,S,D)."""
    if isinstance(x, DTensor):
        return _train_sharded(m, cfg, x)
    return _train_local(m, cfg, x)


def _train_local(m, cfg: ModelConfig, x):
    z, xin, b_, c_, dt, _ = _pre_ssd(m, cfg, x)
    y, _ = ssd_chunked(cfg, xin, b_, c_, dt, m.a_log, m.d_skip)
    y = y.reshape(*x.shape[:2], -1).to(x.dtype)
    return _gated_out(m, cfg, y, z, x.dtype)


def mamba2_prefill(m: Mamba2, cfg: ModelConfig, x):
    """Returns (y, SSD state (B,H,P,N) float32, conv cache (B,w-1,CD))."""
    z, xin, b_, c_, dt, conv_cache = _pre_ssd(m, cfg, x)
    y, state = ssd_chunked(cfg, xin, b_, c_, dt, m.a_log, m.d_skip)
    y = y.reshape(*x.shape[:2], -1).to(x.dtype)
    return _gated_out(m, cfg, y, z, x.dtype), state, conv_cache


def mamba2_decode(m: Mamba2, cfg: ModelConfig, x, state, conv_cache):
    """Single-token step. x: (B,1,D); state: (B,H,P,N); conv: (B,w-1,CD).
    Returns (y, new state, new conv cache)."""
    z, xin, b_, c_, dt, new_conv = _pre_ssd(m, cfg, x, conv_cache)
    a = -torch.exp(m.a_log)
    dt1 = dt[:, 0]                                         # (B,H)
    decay = torch.exp(dt1 * a)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt1, b_[:, 0].float(),
                       xin[:, 0].float())
    state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, c_[:, 0].float())
    y = y + m.d_skip[None, :, None] * xin[:, 0].float()
    y = y.reshape(x.shape[0], 1, -1).to(x.dtype)
    return _gated_out(m, cfg, y, z, x.dtype), state, new_conv


# ---------------------------------------------------------------- sharded ---


class _Heads(NamedTuple):
    """A rank's share of a `Mamba2`'s weights (the module's names): its
    heads' columns of ``w_in`` (z, x and dt) with every B and C column,
    its heads' conv channels with B's and C's, its heads' entries of the
    per-head and per-channel vectors, its rows of ``w_out``; ``groups``
    are the process groups holding the other heads."""

    w_in: torch.Tensor
    conv_w: torch.Tensor
    conv_b: torch.Tensor
    a_log: torch.Tensor
    d_skip: torch.Tensor
    dt_bias: torch.Tensor
    gate_norm: torch.Tensor
    w_out: torch.Tensor
    groups: tuple


_WHOLE = ("w_in", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias",
          "gate_norm")


def _plan(m: Mamba2, cfg: ModelConfig, x):
    """(mesh, the views of the weights `_WHOLE` then ``w_out``, the mesh
    dimensions holding the heads, this rank's first head and head
    count).  The heads lie on the mesh dimensions whose ranks hold rows
    of ``w_out`` where ``ssm_heads`` splits over them (``cache_specs``
    shards the state's heads by the same test); elsewhere every rank
    runs every head."""
    mesh = x.device_mesh
    whole = (Replicate(),) * mesh.ndim
    out_view = tuple(
        Shard(0) if p == Shard(0) and cfg.ssm_heads % mesh.size(k) == 0
        else Replicate() for k, p in enumerate(m.w_out.placements))
    lo, hn = local_offset(mesh, out_view, 0, cfg.ssm_heads)
    head_dims = tuple(k for k, p in enumerate(out_view) if p.is_shard()
                      and mesh.size(k) > 1)
    return mesh, (whole,) * len(_WHOLE) + (out_view,), head_dims, lo, hn


def _select(cfg: ModelConfig, lo: int, hn: int, groups, w_in, conv_w,
            conv_b, a_log, d_skip, dt_bias, gate_norm, w_out) -> _Heads:
    """`_Heads` of heads [lo, lo + hn) from the whole weights (``w_out``
    already the rank's rows)."""
    if hn == cfg.ssm_heads:
        return _Heads(w_in, conv_w, conv_b, a_log, d_skip, dt_bias,
                      gate_norm, w_out, tuple(groups))
    di, n, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    dev = w_in.device

    def ar(a, b):
        return torch.arange(a, b, device=dev)

    mine = ar(lo * p, (lo + hn) * p)
    cols = torch.cat([mine, di + mine, ar(2 * di, 2 * di + 2 * n),
                      2 * di + 2 * n + ar(lo, lo + hn)])
    chans = torch.cat([mine, ar(di, di + 2 * n)])
    hs = slice(lo, lo + hn)
    return _Heads(w_in[:, cols], conv_w[:, chans], conv_b[chans], a_log[hs],
                  d_skip[hs], dt_bias[hs], gate_norm[lo * p:(lo + hn) * p],
                  w_out, tuple(groups))


def _out_view(x_rows, head_dims) -> tuple:
    return tuple(Partial() if k in head_dims else p
                 for k, p in enumerate(x_rows))


def _train_sharded(m: Mamba2, cfg: ModelConfig, x):
    """`mamba2_train` on each rank's heads (`parallel.ax.local_map`): the
    weights gathered whole but ``w_out`` (the rank's rows), the output a
    partial sum over the head dimensions."""
    mesh, views, head_dims, lo, hn = _plan(m, cfg, x)
    rows = rows_view(x.placements)
    groups = [axis_of(mesh, k)[2] for k in head_dims]

    def local(x, *w):
        return _train_local(_select(cfg, lo, hn, groups, *w), cfg, x)

    ws = tuple(getattr(m, k) for k in _WHOLE) + (m.w_out,)
    return local_map(local, mesh, (x,) + ws, (rows,) + views,
                     _out_view(rows, head_dims), x.placements)


@torch.no_grad()
def sharded_step(m: Mamba2, cfg: ModelConfig, x, cache: dict,
                 decode: bool):
    """A prefill (``decode`` False) or a decode step of a DTensor ``x`` on
    each rank's heads, the cache's state (heads on "model") and conv
    window (channels on "model") placed by ``cache_specs`` and written
    in place: the state block is the rank's heads'; the conv window's
    channels of every head are gathered over the head dimensions, and
    each rank keeps its block of them.  Returns y, a partial sum over the
    head dimensions."""
    mesh, views, head_dims, lo, hn = _plan(m, cfg, x)
    st, cv = cache["state"], cache["conv"]
    rows = rows_view(st.placements)
    groups = [axis_of(mesh, k)[2] for k in head_dims]
    ws = [block(getattr(m, k), v)
          for k, v in zip(_WHOLE + ("w_out",), views)]
    w = _select(cfg, lo, hn, groups, *ws)
    xb = block(x, rows)
    if decode:
        conv = block(cv, rows_view(cv.placements))
        if hn != cfg.ssm_heads:
            di, p = cfg.d_inner, cfg.ssm_head_dim
            conv = torch.cat([conv[..., lo * p:(lo + hn) * p],
                              conv[..., di:]], dim=-1)
        y, state, new_conv = mamba2_decode(w, cfg, xb, st._local_tensor,
                                           conv)
    else:
        y, state, new_conv = mamba2_prefill(w, cfg, xb)
    st._local_tensor.copy_(state)
    # the conv window of every channel, then this rank's block of it
    px = hn * cfg.ssm_head_dim
    xs = new_conv[..., :px]
    if hn != cfg.ssm_heads:
        src = tuple(Shard(2) if k in head_dims else r
                    for k, r in enumerate(rows))
        xs = redistribute_local(xs.contiguous(), mesh, src, rows)
    full = torch.cat([xs, new_conv[..., px:]], dim=-1)
    cv._local_tensor.copy_(redistribute_local(
        full, mesh, rows_view(cv.placements), tuple(cv.placements)))
    return wrap(y, mesh, _out_view(rows, head_dims),
                (st.shape[0],) + tuple(x.shape[1:]))
