"""PyTorch port: Multi-head Latent Attention (``repro_torch.models.layers.
mla``) and the DeepSeek-V2 smoke model against the JAX package's, with the
JAX weights carried over, in float32.

The model leg (a dense prologue layer, then two MoE layers with shared
experts, every mixer MLA) holds ``forward_train`` logits, ``loss_fn``, the
prefill logits and every latent cache, and 8 decode steps' logits and
caches within TOL of JAX.  The layer legs hold ``mla_train``'s materialised
softmax and its flash branch (``flash_threshold`` set low), the absorbed
``mla_decode`` at ragged lengths, and ``flash_attention`` at MLA's widths
(q/k 192 against v 128).  The JAX side of the model leg runs once per test
run (``_torch_parity.jax_model_leg``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    check_model_leg,
    few_jax_executables,  # noqa: F401  (autouse)
    jax_model_leg,
)
from repro.configs import get_smoke_config as j_smoke
from repro.models.layers import attention as JA
from repro.models.layers import mla as JM
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attention as TA
from repro_torch.models.layers import mla as TM
from repro_torch.models.weights import load_state

TOL = 1e-5
ARCH = "deepseek_v2_236b"


@pytest.fixture(scope="module")
def jax_deepseek(tmp_path_factory):
    return jax_model_leg(tmp_path_factory, ARCH)


@pytest.mark.parametrize("phase", ["train", "prefill", "decode"])
def test_deepseek_equals_jax(jax_deepseek, phase):
    check_model_leg(jax_deepseek, ARCH, phase, TOL)


def _layer(seed: int = 6, **overrides):
    """(JAX cfg, JAX MLA params, the port's MLA holding them, port cfg)."""
    jcfg = dataclasses.replace(j_smoke(ARCH), **overrides)
    params = JM.init_mla(jax.random.PRNGKey(seed), jcfg)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    flat = {}
    for k, v in params.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{kk}": np.asarray(vv) for kk, vv in v.items()})
        else:
            flat[k] = np.asarray(v)
    mla = load_state(TM.MLA(cfg, torch.float32, "cpu"), flat)
    return jcfg, params, mla, cfg


def _inputs(b: int, s: int, d: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    return x, pos


@pytest.mark.parametrize("branch", ["naive", "flash"])
def test_mla_train_equals_jax(branch):
    """Both branches of ``mla_train`` equal JAX's; the flash branch (16
    tokens past a threshold of 8, chunks of 4) equals the naive one."""
    extra = dict(flash_threshold=8, attn_chunk=4) if branch == "flash" else {}
    jcfg, params, mla, cfg = _layer(**extra)
    x, pos = _inputs(2, 16, cfg.d_model)
    want = np.asarray(JM.mla_train(params, jcfg, jnp.asarray(x),
                                   jnp.asarray(pos)))
    got = TM.mla_train(mla, cfg, torch.as_tensor(x), torch.as_tensor(pos))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=TOL)
    if branch == "flash":
        naive = TM.mla_train(mla, dataclasses.replace(cfg, flash_threshold=64),
                             torch.as_tensor(x), torch.as_tensor(pos))
        np.testing.assert_allclose(got.detach().numpy(),
                                   naive.detach().numpy(), rtol=0, atol=TOL)


def test_mla_decode_equals_jax_and_train():
    """The absorbed decode at ragged lengths equals JAX's (output and both
    latent caches); from a 12-token prefill, 4 decode steps equal
    ``mla_train`` over all 16 tokens (the JAX test's check, tighter)."""
    jcfg, params, mla, cfg = _layer()
    x, pos = _inputs(2, 16, cfg.d_model)
    rng = np.random.default_rng(3)
    ckv = rng.standard_normal((2, 16, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((2, 16, cfg.qk_rope_dim)).astype(np.float32)
    ln = np.asarray([9, 4], np.int32)
    p1 = ln[:, None]
    wy, wc, wk = JM.mla_decode(params, jcfg, jnp.asarray(x[:, :1]),
                               jnp.asarray(p1), jnp.asarray(ckv),
                               jnp.asarray(kr), jnp.asarray(ln))
    gy, gc, gk = TM.mla_decode(mla, cfg, torch.as_tensor(x[:, :1]),
                               torch.as_tensor(p1), torch.as_tensor(ckv),
                               torch.as_tensor(kr),
                               torch.as_tensor(ln).long())
    for what, a, b in (("y", gy, wy), ("ckv", gc, wc), ("krope", gk, wk)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL, err_msg=what)

    tx, tp = torch.as_tensor(x), torch.as_tensor(pos)
    full = TM.mla_train(mla, cfg, tx, tp)
    y, c, k = TM.mla_prefill(mla, cfg, tx[:, :12], tp[:, :12])
    ckv_c = torch.zeros((2, 16, cfg.kv_lora_rank))
    kr_c = torch.zeros((2, 16, cfg.qk_rope_dim))
    ckv_c[:, :12], kr_c[:, :12] = c, k
    ys = [y]
    for i in range(12, 16):
        yy, ckv_c, kr_c = TM.mla_decode(mla, cfg, tx[:, i:i + 1],
                                        tp[:, i:i + 1], ckv_c, kr_c,
                                        torch.full((2,), i))
        ys.append(yy)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(),
                               full.detach().numpy(), rtol=0, atol=1e-4)


def test_flash_attention_at_mla_widths():
    """``flash_attention`` with q/k 192 wide and v 128 (DeepSeek-V2's
    qk_nope + qk_rope against v_head_dim) equals JAX's and the naive
    attention, causal, at 3 chunks of 4."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 12, 2, 192)).astype(np.float32)
    k = rng.standard_normal((1, 12, 2, 192)).astype(np.float32)
    v = rng.standard_normal((1, 12, 2, 128)).astype(np.float32)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    got = TA.flash_attention(tq, tk, tv, q_chunk=4, kv_chunk=4)
    assert got.shape == (1, 12, 2, 128)
    want = JA.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              q_chunk=4, kv_chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(
        got.numpy(), TA.attention_naive(tq, tk, tv, causal=True).numpy(),
        rtol=0, atol=TOL)
