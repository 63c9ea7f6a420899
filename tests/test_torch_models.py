"""PyTorch port: the models the serve path runs (``repro_torch.models``)
against the JAX package's, on the smoke configs with the JAX weights
carried over (`repro_torch.models.weights`): Granite (with a flash and a
bf16 leg), and the zoo's other served configs — Phi-3.5-MoE (the MoE FFN),
InternVL2 (a VLM: seeded vision embeddings in front), Mistral-Nemo
(head_dim != d_model / heads), StarCoder2 (3 query heads a KV head) and
Qwen1.5 (QKV biases).

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

from repro.configs import get_config as j_get
from repro.configs import get_smoke_config as j_smoke
from repro.models import transformer as JT
from repro.models.layers import attention as JA
from repro.models.layers import basic as JB
from repro.models.registry import api
from _torch_parity import (
    few_jax_executables,  # noqa: F401  (autouse)
    jax_layer_caches,
    jax_model_leg,
    port_model,
)
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import encdec as TE
from repro_torch.models import registry as TR
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attention as TA
from repro_torch.models.layers import basic as TB
from repro_torch.models.layers.basic import dtype_of
from repro_torch.models.transformer import Transformer
from repro_torch.models.weights import from_jax_params

TOL = 1e-5
LOGIT_TOL_BF16 = 0.1    # smoke logits reach ~4; bf16 keeps 8 bits
LEGS = {"naive": {}, "flash": dict(flash_threshold=8, attn_chunk=4),
        "bf16": dict(dtype="bfloat16", param_dtype="bfloat16")}
B, S, CACHE = 2, 12, 16
ZOO = ["phi3_5_moe_42b", "internvl2_2b", "mistral_nemo_12b",
       "starcoder2_15b", "qwen1_5_110b"]
ZOO_CACHE = 32          # InternVL2's smoke puts 8 vision tokens in front
# the families that are model-only (no serve path): their parity legs are in
# test_torch_mla.py, test_torch_mamba2.py and test_torch_encdec.py
NEW = ["deepseek_v2_236b", "mamba2_370m", "jamba_1_5_large_398b",
       "whisper_base"]


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
    """The port's configs are the JAX package's ten, in its order, field
    for field, under the JAX ids and public aliases; the kinds that once
    were not ported (MLA, SSD, the hybrid, the encoder-decoder) build
    through the registry, and a decoder refuses the audio family."""
    from repro.configs import ALIASES as J_ALIASES
    from repro.configs import ARCH_IDS as J_IDS
    from repro_torch.configs import ALIASES

    assert ARCH_IDS == J_IDS and ALIASES == J_ALIASES
    for alias, name in J_ALIASES.items():
        for key in (name, alias):
            assert dataclasses.asdict(get_config(key)) == \
                dataclasses.asdict(j_get(key))
        assert dataclasses.asdict(get_smoke_config(name)) == \
            dataclasses.asdict(j_smoke(name))
    for name in NEW:
        cfg = get_smoke_config(name)
        model = TR.api(cfg).init_params(device="cpu")
        assert model.param_count() > 0
    with pytest.raises(ValueError, match="EncDec"):
        Transformer(get_smoke_config("whisper_base"), device="cpu")


# ------------------------------------------------ the zoo's served configs ---


def _vision(cfg):
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(1).standard_normal(
        (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)


def _caches_np(caches):
    return (np.stack([c["k"].float().numpy() for c in caches]),
            np.stack([c["v"].float().numpy() for c in caches]))


@pytest.fixture(scope="module")
def jax_zoo():
    """Per served config: the JAX params, prefill logits and caches (with
    the vision prefix for the VLM), then one decode step at ragged lengths,
    and a bf16-parameter Phi whose router init_moe keeps in float32."""
    res = {}
    toks = np.random.default_rng(0).integers(1, 512, (B, S)).astype(np.int32)
    for name in ZOO:
        cfg = j_smoke(name)
        m = api(cfg)
        params = m.init_params(jax.random.PRNGKey(0))
        ve = _vision(cfg)
        kw = {} if ve is None else {"vision_embeds": jnp.asarray(ve)}
        logits, caches = m.prefill(params, jnp.asarray(toks),
                                   m.init_caches(B, ZOO_CACHE), **kw)
        pre = (_np(logits), _np(caches["slots"][0]["k"]),
               _np(caches["slots"][0]["v"]))
        tok = np.argmax(pre[0][:, -1], -1)[:, None].astype(np.int32)
        s_tot = S + cfg.vision_tokens
        ln = np.asarray([s_tot, s_tot - 3], np.int32)
        lg, caches = m.decode_step(params, jnp.asarray(tok), caches,
                                   jnp.asarray(ln))
        dec = (_np(lg), _np(caches["slots"][0]["k"]),
               _np(caches["slots"][0]["v"]))
        res[name] = dict(cfg=cfg, params=jax.tree.map(np.asarray, params),
                         toks=toks, ve=ve, tok=tok, ln=ln, pre=pre, dec=dec,
                         count=JT.param_count(params))
    bf16 = dataclasses.replace(j_smoke("phi3_5_moe_42b"), dtype="bfloat16",
                               param_dtype="bfloat16")
    res["phi_bf16"] = dict(cfg=bf16, params=jax.tree.map(
        np.asarray, api(bf16).init_params(jax.random.PRNGKey(0))))
    return res


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("name", ZOO)
def test_zoo_logits_and_caches_equal_jax(jax_zoo, name, phase):
    """Logits and every layer's K/V cache within 1e-5 of JAX's, after the
    prefill and after one decode step; the same greedy token."""
    leg = jax_zoo[name]
    model = from_jax_params(ModelConfig(**dataclasses.asdict(leg["cfg"])),
                            leg["params"], device="cpu")
    caches = model.init_caches(B, ZOO_CACHE)
    ve = None if leg["ve"] is None else torch.as_tensor(leg["ve"])
    logits, caches = model.prefill(torch.as_tensor(leg["toks"]), caches, ve)
    got = (logits.numpy(), *_caches_np(caches))
    if phase == "decode":
        lg, caches = model.decode_step(torch.as_tensor(leg["tok"]), caches,
                                       torch.as_tensor(leg["ln"]))
        got = (lg.numpy(), *_caches_np(caches))
    want = leg["pre" if phase == "prefill" else "dec"]
    for what, a, b in zip(("logits", "k", "v"), got, want):
        assert a.shape == b.shape, (what, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=what)
    np.testing.assert_array_equal(got[0].argmax(-1), want[0].argmax(-1))


@pytest.mark.parametrize("name", ZOO + ["phi_bf16"])
def test_zoo_weight_carry_covers_every_parameter(jax_zoo, name):
    """Every JAX leaf lands in a port parameter of the same name, shape and
    value (bf16 values exactly); the MoE router stays float32 under bf16
    parameters, as ``init_moe`` makes it."""
    from repro_torch.models.weights import jax_state_dict

    leg = jax_zoo[name]
    cfg = ModelConfig(**dataclasses.asdict(leg["cfg"]))
    model = from_jax_params(cfg, leg["params"], device="cpu")
    flat = jax_state_dict(cfg, leg["params"])
    own = dict(model.named_parameters())
    assert set(flat) == set(own)
    assert model.param_count() == sum(np.asarray(a).size
                                      for a in jax.tree.leaves(leg["params"]))
    for key, arr in flat.items():
        np.testing.assert_array_equal(own[key].float().numpy(),
                                      np.asarray(arr, np.float32),
                                      err_msg=key)
    if cfg.family == "moe":
        for layer in model.layers:
            assert layer.ffn.router.dtype == torch.float32
            assert layer.ffn.w_gate.dtype == dtype_of(cfg.param_dtype)


def test_vlm_prefill_needs_vision_embeds(jax_zoo):
    """A VLM prefill without vision embeddings fails on both sides: JAX's
    ``_embed_inputs`` asserts, the port raises a ValueError naming them."""
    leg = jax_zoo["internvl2_2b"]
    m = api(leg["cfg"])
    with pytest.raises(AssertionError):
        m.prefill(leg["params"], jnp.asarray(leg["toks"]),
                  m.init_caches(B, ZOO_CACHE))
    model = from_jax_params(ModelConfig(**dataclasses.asdict(leg["cfg"])),
                            leg["params"], device="cpu")
    with pytest.raises(ValueError, match="vision_embeds"):
        model.prefill(torch.as_tensor(leg["toks"]),
                      model.init_caches(B, ZOO_CACHE))


@pytest.mark.parametrize("name", ARCH_IDS)
def test_full_config_param_count_equals_jax(name):
    """Each full config, built on the meta device (no memory), has
    exactly as many parameters as JAX's ``init_params`` under
    ``jax.eval_shape`` (the audio family through both encoder-decoders)."""
    cfg = get_config(name)
    model = TR.model_class(cfg)(cfg, device="meta", init=False)
    shapes = jax.eval_shape(lambda: api(j_get(name)).init_params(
        jax.random.PRNGKey(0)))
    assert model.param_count() == sum(x.size for x in jax.tree.leaves(shapes))


# ---------------------------------------- the model-only families, facade ---


@pytest.mark.parametrize("name", NEW)
def test_new_weight_carry_covers_every_parameter(tmp_path_factory, name):
    """Every leaf of the JAX tree (scan-stacked slots of a period of 8,
    the prologue, the stacked encoder / decoder) lands in a port
    parameter of the same value; the counts agree; an SSD's ``a_log`` /
    ``d_skip`` / ``dt_bias`` stay float32 under bf16 parameters, as
    ``init_mamba2`` makes them."""
    rec = jax_model_leg(tmp_path_factory, name)
    model = port_model(rec, name)
    assert model.param_count() == int(rec["count"])
    own = dict(model.named_parameters())
    for key, arr in rec.items():
        if key.startswith("param/"):
            np.testing.assert_array_equal(own[key[6:]].numpy(), arr,
                                          err_msg=key)
    bf16 = dataclasses.replace(model.cfg, param_dtype="bfloat16")
    for mod in TR.api(bf16).init_params(device="cpu").modules():
        if hasattr(mod, "a_log"):
            assert {mod.a_log.dtype, mod.d_skip.dtype, mod.dt_bias.dtype} \
                == {torch.float32} and mod.w_in.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ARCH_IDS)
def test_registry_api_per_family(name):
    """``api(cfg)`` has the JAX facade's fields; ``init_params`` builds the
    family's model from a seed or a generator; ``init_caches`` gives each
    layer's cache in JAX's shapes and dtypes (the per-layer list for a
    decoder, the L-stacked dict for the encoder-decoder)."""
    cfg = get_smoke_config(name)
    m, jm = TR.api(cfg), api(j_smoke(name))
    assert set(vars(m)) == set(vars(jm))
    audio = cfg.family == "audio"
    assert m.module is (TE if audio else TT)
    model = m.init_params(device="cpu", seed=3)
    assert type(model) is (TE.EncDec if audio else Transformer)
    again = m.init_params(device="cpu",
                          generator=torch.Generator().manual_seed(3))
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    got = m.init_caches(2, 8, device="cpu")
    want = jax_layer_caches(cfg, jax.tree.map(np.asarray,
                                              jm.init_caches(2, 8)))
    if audio:
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in g.items()} \
            == {k: (v.shape, str(v.dtype)) for k, v in w.items()}


def test_shapes_equal_jax():
    from repro.models import registry as JR

    assert TR.SHAPES == JR.SHAPES
    for name in ARCH_IDS:
        for shape in TR.SHAPES:
            assert TR.shape_applicable(get_config(name), shape) == \
                JR.shape_applicable(j_get(name), shape)


def _batch(cfg, rng, b: int, s: int) -> dict:
    """Tokens and labels (B, S), and a VLM's vision embeddings or an
    audio model's frames, drawn as the JAX tests draw them."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
             "labels": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("name", ARCH_IDS)
def test_loss_and_gradients_finite(name):
    """The port's ``loss_fn`` is differentiable for every family: a finite
    loss, a finite gradient on every parameter, not all zero (the JAX
    ``test_arch_smoke_forward_and_train_step``'s check; the gradients'
    parity with ``jax.grad`` is held in ``tests/test_torch_train.py``)."""
    cfg = get_smoke_config(name)
    m = TR.api(cfg)
    model = m.init_params(device="cpu", seed=0).requires_grad_(True)
    loss = m.loss_fn(model, _batch(cfg, np.random.default_rng(0), 2, 32))
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    total = 0.0
    for pname, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), \
            pname
        total += float((p.grad.double() ** 2).sum())
    assert np.isfinite(total) and total > 0


@pytest.mark.parametrize("name", ["qwen1_5_110b", "jamba_1_5_large_398b",
                                  "mamba2_370m", "deepseek_v2_236b",
                                  "whisper_base", "internvl2_2b",
                                  "phi3_5_moe_42b"])
def test_decode_matches_train_forward(name):
    """The JAX test of the same name on the port: a prefill of 16 tokens,
    then 8 teacher-forced decode steps, equal ``forward_train`` over all
    24 at capacity factor 64 (no token dropped), within 1e-4 (JAX's test
    allows 2e-2; the SSD's chunked and stepwise sums differ in order)."""
    cfg = dataclasses.replace(get_smoke_config(name), capacity_factor=64.0)
    m = TR.api(cfg)
    model = m.init_params(device="cpu", seed=0)
    b, s, spre = 2, 24, 16
    batch = _batch(cfg, np.random.default_rng(1), b, s)
    toks = torch.as_tensor(batch["tokens"], dtype=torch.int32)
    nv = cfg.vision_tokens if cfg.family == "vlm" else 0
    caches = m.init_caches(b, s + nv, device="cpu")
    if cfg.family == "audio":
        full = m.forward_train(model, tokens=toks, frames=batch["frames"])
        logits, caches = m.prefill(model, toks[:, :spre], batch["frames"],
                                   caches)
    else:
        ve = batch.get("vision_embeds")
        full = m.forward_train(model, tokens=toks, vision_embeds=ve)
        logits, caches = m.prefill(model, toks[:, :spre], caches, ve)
    full = full.detach()[:, nv:]
    errs = [float((full[:, spre - 1:spre] - logits).abs().max())]
    for i in range(spre, s):
        ln = torch.full((b,), nv + i, dtype=torch.int32)
        logits, caches = m.decode_step(model, toks[:, i:i + 1], caches, ln)
        errs.append(float((full[:, i:i + 1] - logits).abs().max()))
    assert max(errs) < 1e-4, (name, errs)
