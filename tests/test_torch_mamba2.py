"""PyTorch port: Mamba-2's SSD (``repro_torch.models.layers.mamba2``), the
Mamba2 smoke model (SSD only) and the Jamba smoke model (one period of 8:
7 SSD layers and an attention layer, MoE on the odd layers, 4 experts
top-2) against the JAX package's, with the JAX weights carried over, in
float32.

The model legs hold ``forward_train`` logits, ``loss_fn``, the prefill
logits and every cache (SSD state and conv inputs, attention K/V), and 8
decode steps' logits and caches within TOL_SSD of JAX: 1e-4, since the SSD
sums decays and states through cumulative sums over 16-token chunks in
float32, which XLA and torch order differently (the largest differences
seen are ~2e-5, on Jamba's states).  The layer legs hold ``ssd_chunked``
(both branches, a length that is no chunk multiple, with and without an
initial state) against ``ssd_ref`` and JAX, the softplus past torch's
linear cut, and the block's decode against its whole-sequence form.
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
from repro.models.layers import mamba2 as JM
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mamba2 as TM
from repro_torch.models.weights import load_state

TOL = 1e-5
TOL_SSD = 1e-4
ARCHS = ["mamba2_370m", "jamba_1_5_large_398b"]


@pytest.fixture(scope="module")
def jax_legs(tmp_path_factory):
    return {a: jax_model_leg(tmp_path_factory, a) for a in ARCHS}


@pytest.mark.parametrize("phase", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssd_models_equal_jax(jax_legs, arch, phase):
    check_model_leg(jax_legs[arch], arch, phase, TOL_SSD)


def _layer(seed: int = 0, **overrides):
    """(JAX cfg, params, the port's Mamba2 holding them, port cfg), the
    Mamba2 smoke config at chunk 8 with ``overrides``; the float32
    parameters drawn away from their constant inits."""
    jcfg = dataclasses.replace(j_smoke("mamba2_370m"), ssm_chunk=8,
                               **overrides)
    params = JM.init_mamba2(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    params = {k: np.asarray(v) for k, v in params.items()}
    for k in ("a_log", "d_skip", "dt_bias", "conv_b"):
        params[k] = (params[k]
                     + rng.standard_normal(params[k].shape) * 0.3
                     ).astype(np.float32)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    m = load_state(TM.Mamba2(cfg, torch.float32, "cpu"), params)
    return jcfg, {k: jnp.asarray(v) for k, v in params.items()}, m, cfg


@pytest.mark.parametrize("vectorized", [False, True])
def test_ssd_chunked_equals_ref_and_jax(vectorized):
    """37 tokens at chunk 8 (4 whole chunks and a padded fifth): both
    branches equal the sequential ``ssd_ref`` and JAX's ``ssd_chunked``
    (output and final state), from a zero and from a given state."""
    jcfg, params, m, cfg = _layer(ssd_vectorized=vectorized)
    x = np.random.default_rng(1).standard_normal(
        (2, 37, cfg.d_model)).astype(np.float32)
    _, xin, b_, c_, dt, _ = TM._pre_ssd(m, cfg, torch.as_tensor(x))
    _, jxin, jb, jc, jdt, _ = JM._pre_ssd(params, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(dt.numpy(), np.asarray(jdt), rtol=0, atol=TOL)
    y, st = TM.ssd_chunked(cfg, xin, b_, c_, dt, m.a_log, m.d_skip)
    ref = TM.ssd_ref(cfg, xin, b_, c_, dt, m.a_log, m.d_skip)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=0, atol=TOL_SSD)
    jy, jst = JM.ssd_chunked(jcfg, jxin, jb, jc, jdt, params["a_log"],
                             params["d_skip"])
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=0,
                               atol=TOL)
    assert st.shape == (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    # continue from that state: the second half equals a whole run's tail
    y2, st2 = TM.ssd_chunked(cfg, xin, b_, c_, dt, m.a_log, m.d_skip,
                             state0=st)
    jy2, jst2 = JM.ssd_chunked(jcfg, jxin, jb, jc, jdt, params["a_log"],
                               params["d_skip"], state0=jst)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), rtol=0,
                               atol=TOL_SSD)
    np.testing.assert_allclose(st2.numpy(), np.asarray(jst2), rtol=0,
                               atol=TOL_SSD)
    cat = torch.cat([xin, xin], 1), torch.cat([b_, b_], 1), \
        torch.cat([c_, c_], 1), torch.cat([dt, dt], 1)
    whole = TM.ssd_ref(cfg, *cat, m.a_log, m.d_skip)
    np.testing.assert_allclose(y2.numpy(), whole[:, 37:].numpy(), rtol=0,
                               atol=TOL_SSD)


def test_softplus_equals_jax():
    """JAX's softplus, ``logaddexp(x, 0)``, across torch's linear cut at
    20 and far into both tails, within one float32 rounding (XLA flushes
    the denormal at -100 to 0)."""
    x = np.asarray([-100.0, -20.0, -1.0, 0.0, 1e-3, 5.0, 19.9, 20.0, 20.1,
                    25.0, 40.0, 100.0], np.float32)
    np.testing.assert_allclose(TM.softplus(torch.as_tensor(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=2e-7, atol=1e-30)


def test_mamba2_block_decode_matches_train():
    """A prefill of 11 tokens (its conv cache: the last w-1 inputs before
    the activation), then 6 single-token steps, equal ``mamba2_train``
    over all 17 — and JAX's prefill state and conv cache."""
    jcfg, params, m, cfg = _layer(seed=3)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (2, 17, cfg.d_model)).astype(np.float32))
    full = TM.mamba2_train(m, cfg, x)
    y, state, conv = TM.mamba2_prefill(m, cfg, x[:, :11])
    jy, jstate, jconv = JM.mamba2_prefill(params, jcfg,
                                          jnp.asarray(x[:, :11].numpy()))
    for what, a, b in (("y", y, jy), ("state", state, jstate),
                       ("conv", conv, jconv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL_SSD, err_msg=what)
    ys = [y]
    for i in range(11, 17):
        yy, state, conv = TM.mamba2_decode(m, cfg, x[:, i:i + 1], state,
                                           conv)
        ys.append(yy)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(),
                               rtol=0, atol=TOL_SSD)
