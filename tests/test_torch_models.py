"""PyTorch port: the dense model the serve path runs (``repro_torch.models``)
against the JAX package's, on the smoke Granite config with the JAX
weights carried over (`repro_torch.models.weights`).

``prefill`` and ``decode_step`` logits and the K/V caches must agree within
1e-5 in float32 (the config's own dtype; XLA and torch sum the products
in other orders).  A leg at ``flash_threshold=8, attn_chunk=4`` reaches
``flash_attention``.  A bfloat16 leg of the same config states its own
looser tolerance (LOGIT_TOL_BF16: activations round to bf16 after every
product, at other points in the two frameworks) and checks no tokens.  The
JAX side runs once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import transformer as JT
from repro.models.layers import attention as JA
from repro.models.layers import basic as JB
from repro.models.registry import api
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attention as TA
from repro_torch.models.layers import basic as TB
from repro_torch.models.transformer import Transformer
from repro_torch.models.weights import from_jax_params

TOL = 1e-5
LOGIT_TOL_BF16 = 0.1    # smoke logits reach ~4; bf16 keeps 8 bits
LEGS = {"naive": {}, "flash": dict(flash_threshold=8, attn_chunk=4),
        "bf16": dict(dtype="bfloat16", param_dtype="bfloat16")}
B, S, CACHE = 2, 12, 16


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def jax_side():
    """Per leg: the JAX params, prefill logits and caches, then one
    decode step's logits and caches."""
    res = {}
    toks = np.random.default_rng(0).integers(1, 512, (B, S)).astype(np.int32)
    for leg, extra in LEGS.items():
        cfg = dataclasses.replace(j_smoke("granite_8b"), **extra)
        m = api(cfg)
        params = m.init_params(jax.random.PRNGKey(0))
        caches = m.init_caches(B, CACHE)
        logits, caches = m.prefill(params, jnp.asarray(toks), caches)
        pre = (_np(logits), _np(caches["slots"][0]["k"]),
               _np(caches["slots"][0]["v"]))
        tok = np.argmax(pre[0][:, -1], -1)[:, None].astype(np.int32)
        ln = np.asarray([S, S - 3], np.int32)   # ragged lengths
        lg, caches = m.decode_step(params, jnp.asarray(tok), caches,
                                   jnp.asarray(ln))
        dec = (_np(lg), _np(caches["slots"][0]["k"]),
               _np(caches["slots"][0]["v"]))
        res[leg] = dict(cfg=cfg, params=jax.tree.map(np.asarray, params),
                        toks=toks, tok=tok, ln=ln, pre=pre, dec=dec,
                        count=JT.param_count(params))
    return res


def _port(leg):
    model = from_jax_params(ModelConfig(**dataclasses.asdict(leg["cfg"])),
                            leg["params"], device="cpu")
    caches = model.init_caches(B, CACHE)
    logits, caches = model.prefill(torch.as_tensor(leg["toks"]), caches)
    pre = (logits.float().numpy(),
           np.stack([c["k"].float().numpy() for c in caches]),
           np.stack([c["v"].float().numpy() for c in caches]))
    lg, caches = model.decode_step(torch.as_tensor(leg["tok"]), caches,
                                   torch.as_tensor(leg["ln"]))
    dec = (lg.float().numpy(),
           np.stack([c["k"].float().numpy() for c in caches]),
           np.stack([c["v"].float().numpy() for c in caches]))
    return model, pre, dec


@pytest.mark.parametrize("leg", ["naive", "flash"])
@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_logits_and_caches_equal_jax(jax_side, leg, phase):
    want = jax_side[leg]["pre" if phase == "prefill" else "dec"]
    _, pre, dec = _port(jax_side[leg])
    got = pre if phase == "prefill" else dec
    for name, a, b in zip(("logits", "k", "v"), got, want):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=name)
    if phase == "decode":   # the same greedy token from the same logits
        np.testing.assert_array_equal(got[0].argmax(-1), want[0].argmax(-1))


def test_bf16_leg_within_its_tolerance(jax_side):
    leg = jax_side["bf16"]
    model, pre, dec = _port(leg)
    assert model.embed.tok.dtype == torch.bfloat16
    for got, want in ((pre, leg["pre"]), (dec, leg["dec"])):
        err = np.abs(got[0] - want[0]).max()
        assert err < LOGIT_TOL_BF16, err


def test_weight_carry_covers_every_parameter(jax_side):
    leg = jax_side["naive"]
    model, _, _ = _port(leg)
    assert model.param_count() == leg["count"]
    np.testing.assert_array_equal(model.layers[1].mixer.wk.numpy(),
                                  leg["params"]["slots"][0]["mixer"]["wk"][1])


def test_layers_equal_jax():
    """rmsnorm, rope (float32 frequencies), the SwiGLU MLP, the naive,
    flash and dense-decode attention, one at a time on random inputs."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 8)).astype(np.int32)
    np.testing.assert_allclose(
        TB.rope_apply(torch.as_tensor(x), torch.as_tensor(pos), 1e4).numpy(),
        _np(JB.rope_apply(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        rtol=0, atol=TOL)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        TB.rmsnorm_apply(torch.as_tensor(scale), torch.as_tensor(x)).numpy(),
        _np(JB.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        rtol=0, atol=TOL)
    q = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    naive = TA.attention_naive(tq, tk, tv, causal=True).numpy()
    np.testing.assert_allclose(
        naive, _np(JA.attention_naive(jq, jk, jv, causal=True)),
        rtol=0, atol=TOL)
    flash = TA.flash_attention(tq, tk, tv, q_chunk=4, kv_chunk=4).numpy()
    np.testing.assert_allclose(
        flash, _np(JA.flash_attention(jq, jk, jv, q_chunk=4, kv_chunk=4)),
        rtol=0, atol=TOL)
    np.testing.assert_allclose(flash, naive, rtol=0, atol=TOL)
    ln = np.asarray([8, 5], np.int32)
    np.testing.assert_allclose(
        TA.decode_attention(tq[:, :1], tk, tv, torch.as_tensor(ln)).numpy(),
        _np(JA.decode_attention(jq[:, :1], jk, jv, jnp.asarray(ln))),
        rtol=0, atol=TOL)


def test_initializer_scaling_and_seed():
    """Weights from an explicit generator with the JAX fan-in scaling:
    std ~ 1/sqrt(fan_in), norms at 1, the same seed the same weights."""
    cfg = get_smoke_config("granite_8b")
    a = Transformer(cfg, device="cpu", seed=5)
    b = Transformer(cfg, device="cpu", seed=5)
    c = Transformer(cfg, device="cpu", seed=6)
    assert torch.equal(a.layers[0].ffn.w_down, b.layers[0].ffn.w_down)
    assert not torch.equal(a.layers[0].ffn.w_down, c.layers[0].ffn.w_down)
    std = float(a.layers[0].ffn.w_down.std()) * cfg.d_ff ** 0.5
    assert 0.9 < std < 1.1, std
    assert bool((a.final_norm.scale == 1).all())
    g = torch.Generator().manual_seed(5)
    d = Transformer(cfg, device="cpu", generator=g)
    assert torch.equal(a.embed.tok, d.embed.tok)


def test_configs_and_unported_kinds():
    """The port's configs equal the JAX package's field for field; an
    architecture or layer kind that is not ported raises and names
    ROADMAP.md."""
    from repro.configs import get_config as j_get

    for name in ("granite_8b", "granite-8b"):
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(j_get(name))
    assert dataclasses.asdict(get_smoke_config("granite_8b")) == \
        dataclasses.asdict(j_smoke("granite_8b"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("mamba2_370m")
    moe = ModelConfig(**dataclasses.asdict(j_smoke("phi3_5_moe_42b")))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Transformer(moe, device="cpu")
