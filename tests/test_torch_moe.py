"""PyTorch port: the MoE FFN (``repro_torch.models.layers.moe``) against the
JAX package's, on Phi-3.5-MoE's smoke widths with the JAX weights carried
over.

Routing is integer work and must equal JAX bit for bit: the chosen expert
ids, each capacity slot's token (``slot_token``) and which (token, choice)
pairs dropped, under global and block-local dispatch, with and without
drops.  JAX keeps those inside ``moe_apply``, so `_jax_dispatch` repeats
its dispatch lines verbatim and `test_jax_dispatch_copy_is_faithful` holds
that copy to ``moe_apply``'s output exactly.  Outputs agree within 1e-5 in
float32 (XLA and torch sum the expert products in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models.layers import moe as JM
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import moe as TM

TOL = 1e-5
# (name, config changes, tokens as (B, S)): global dispatch without drops,
# global at capacity_factor 1.0 (drops), block-local (4 blocks) with and
# without drops
CASES = {
    "global": (dict(), (2, 16)),
    "global_drops": (dict(capacity_factor=1.0), (4, 32)),
    "blocks": (dict(moe_dispatch_blocks=4), (2, 16)),
    "blocks_drops": (dict(moe_dispatch_blocks=4, capacity_factor=1.0),
                     (4, 32)),
}


def _jax_dispatch(cfg, gates, idx, t):
    """``repro.models.layers.moe.moe_apply``'s dispatch, line for line:
    (slot_token, slot_gate, kept (T, K), c)."""
    e, k = cfg.moe_experts, cfg.moe_top_k
    blocks = max(cfg.moe_dispatch_blocks, 1)
    tk = t * k
    flat_e = idx.reshape(tk)
    if blocks > 1 and tk % blocks == 0:
        per = tk // blocks
        c_blk = max(8, -(-int(np.ceil(per / e * cfg.capacity_factor)) // 8) * 8)
        c = blocks * c_blk
        e2 = flat_e.reshape(blocks, per)
        order_b = jnp.argsort(e2, axis=1, stable=True)
        sorted_e = jnp.take_along_axis(e2, order_b, axis=1)
        first = jax.vmap(
            lambda row: jnp.searchsorted(row, row, side="left"))(sorted_e)
        rank = jnp.arange(per, dtype=jnp.int32)[None] - first.astype(jnp.int32)
        keep = rank < c_blk
        cap_idx = jnp.arange(blocks, dtype=jnp.int32)[:, None] * c_blk + rank
        dest = jnp.where(keep, sorted_e * c + cap_idx, e * c).reshape(-1)
        order = (order_b
                 + jnp.arange(blocks, dtype=jnp.int32)[:, None] * per).reshape(-1)
        keep = keep.reshape(-1)
    else:
        c = JM.capacity(cfg, t)
        order = jnp.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        rank = jnp.arange(tk, dtype=jnp.int32) - jnp.searchsorted(
            sorted_e, sorted_e, side="left").astype(jnp.int32)
        keep = rank < c
        dest = jnp.where(keep, sorted_e * c + rank, e * c)
    slot_token = jnp.full((e * c + 1,), -1, jnp.int32).at[dest].set(
        (order // k).astype(jnp.int32), mode="drop")[: e * c]
    slot_gate = jnp.zeros((e * c + 1,), jnp.float32).at[dest].set(
        gates.reshape(tk)[order], mode="drop")[: e * c]
    kept = jnp.zeros(tk, bool).at[order].set(keep).reshape(t, k)
    return slot_token, slot_gate, kept, c


def _jax_route(params, cfg, xf):
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32), params["router"])
    gates, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.moe_top_k)
    return gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9), idx


def _jax_combine(params, cfg, x, slot_token, slot_gate, c):
    """The rest of JAX's ``moe_apply`` after its dispatch, line for line."""
    b, s, d = x.shape
    e, t = cfg.moe_experts, b * s
    xf = x.reshape(t, d)
    valid = slot_token >= 0
    xg = jnp.where(valid[:, None], xf[jnp.maximum(slot_token, 0)],
                   jnp.zeros((), x.dtype)).reshape(e, c, d)
    g = jnp.einsum("ecd,edf->ecf", xg, params["w_gate"])
    u = jnp.einsum("ecd,edf->ecf", xg, params["w_up"])
    h = jax.nn.silu(g.astype(jnp.float32)).astype(x.dtype) * u
    y = jnp.einsum("ecf,efd->ecd", h, params["w_down"]).reshape(e * c, d)
    contrib = y * slot_gate[:, None].astype(y.dtype)
    out = jnp.zeros((t, d), x.dtype).at[jnp.maximum(slot_token, 0)].add(
        jnp.where(valid[:, None], contrib, jnp.zeros((), y.dtype)))
    return out.reshape(b, s, d)


def _cfg(case):
    return dataclasses.replace(j_smoke("phi3_5_moe_42b"), **CASES[case][0])


def _port_moe(cfg, params) -> TM.MoE:
    moe = TM.MoE(ModelConfig(**dataclasses.asdict(cfg)), torch.float32,
                 "cpu")
    with torch.no_grad():
        for name, p in moe.named_parameters():
            p.copy_(torch.as_tensor(np.array(params[name])))
    return moe


@pytest.fixture(scope="module")
def jax_side():
    """Per case: params, input, JAX's route, dispatch, moe_apply and
    moe_ref outputs (numpy)."""
    res = {}
    for i, case in enumerate(CASES):
        cfg = _cfg(case)
        b, s = CASES[case][1]
        params = JM.init_moe(jax.random.PRNGKey(i), cfg)
        x = np.random.default_rng(i).standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
        jx = jnp.asarray(x)
        gates, idx = _jax_route(params, cfg, jx.reshape(b * s, -1))
        st, sg, kept, c = _jax_dispatch(cfg, gates, idx, b * s)
        res[case] = dict(
            cfg=cfg, params=jax.tree.map(np.asarray, params), x=x,
            idx=np.asarray(idx), gates=np.asarray(gates),
            slot_token=np.asarray(st), slot_gate=np.asarray(sg),
            kept=np.asarray(kept), c=c,
            out=np.asarray(JM.moe_apply(params, cfg, jx)),
            copy_out=np.asarray(_jax_combine(params, cfg, jx, st, sg, c)),
            ref=np.asarray(JM.moe_ref(params, cfg, jx)))
    return res


@pytest.mark.parametrize("case", list(CASES))
def test_jax_dispatch_copy_is_faithful(jax_side, case):
    """The test's copy of JAX's dispatch, combined as JAX combines, gives
    JAX's ``moe_apply`` output exactly, so comparing with the copy is
    comparing with JAX."""
    leg = jax_side[case]
    np.testing.assert_array_equal(leg["copy_out"], leg["out"])


@pytest.mark.parametrize("case", list(CASES))
def test_routing_equals_jax_bit_for_bit(jax_side, case):
    """Expert ids, gates' order, ``slot_token``, the capacity and the drop
    mask equal JAX's; the drop cases do drop."""
    leg = jax_side[case]
    cfg = ModelConfig(**dataclasses.asdict(leg["cfg"]))
    moe = _port_moe(leg["cfg"], leg["params"])
    xf = torch.as_tensor(leg["x"]).reshape(-1, cfg.d_model)
    gates, idx = TM.route(moe, cfg, xf)
    np.testing.assert_array_equal(idx.numpy(), leg["idx"])
    np.testing.assert_allclose(gates.numpy(), leg["gates"], rtol=0, atol=TOL)
    dp = TM.dispatch(cfg, gates, idx)
    assert dp.c == leg["c"]
    np.testing.assert_array_equal(dp.slot_token.numpy(), leg["slot_token"])
    np.testing.assert_array_equal(dp.kept.numpy(), leg["kept"])
    np.testing.assert_allclose(dp.slot_gate.numpy(), leg["slot_gate"],
                               rtol=0, atol=TOL)
    if case.endswith("drops"):
        assert not leg["kept"].all(), "the drop case dropped nothing"
    else:
        assert leg["kept"].all()


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_and_ref_equal_jax(jax_side, case):
    leg = jax_side[case]
    cfg = ModelConfig(**dataclasses.asdict(leg["cfg"]))
    moe = _port_moe(leg["cfg"], leg["params"])
    x = torch.as_tensor(leg["x"])
    np.testing.assert_allclose(TM.moe_apply(moe, cfg, x).numpy(), leg["out"],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(TM.moe_ref(moe, cfg, x).numpy(), leg["ref"],
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("case", ["global", "blocks"])
def test_moe_apply_equals_its_ref_without_drops(jax_side, case):
    """With every pair kept, the capacity dispatch computes the dense
    oracle's function."""
    leg = jax_side[case]
    cfg = ModelConfig(**dataclasses.asdict(leg["cfg"]))
    moe = _port_moe(leg["cfg"], leg["params"])
    x = torch.as_tensor(leg["x"])
    np.testing.assert_allclose(TM.moe_apply(moe, cfg, x).numpy(),
                               TM.moe_ref(moe, cfg, x).numpy(),
                               rtol=0, atol=TOL)


def test_top_k_ties_take_the_lower_expert_first():
    """``jax.lax.top_k`` orders equal probabilities by expert id; so does
    the port's stable sort.  A router with equal columns ties every expert
    on every token, so both pick experts 0 and 1."""
    cfg = j_smoke("phi3_5_moe_42b")
    params = JM.init_moe(jax.random.PRNGKey(3), cfg)
    router = np.repeat(np.asarray(params["router"])[:, :1], cfg.moe_experts,
                       axis=1)
    params = dict(params, router=jnp.asarray(router))
    x = np.random.default_rng(3).standard_normal((5, cfg.d_model)).astype(
        np.float32)
    _, jidx = _jax_route(params, cfg, jnp.asarray(x))
    moe = _port_moe(cfg, jax.tree.map(np.asarray, params))
    _, tidx = TM.route(moe, ModelConfig(**dataclasses.asdict(cfg)),
                       torch.as_tensor(x))
    np.testing.assert_array_equal(np.asarray(jidx), [[0, 1]] * 5)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def test_capacity_equals_jax():
    for case in CASES:
        cfg = _cfg(case)
        tcfg = ModelConfig(**dataclasses.asdict(cfg))
        for t in (1, 7, 8, 64, 1000, 4096):
            assert TM.capacity(tcfg, t) == JM.capacity(cfg, t), (case, t)
