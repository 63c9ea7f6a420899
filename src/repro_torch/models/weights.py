"""Carry a JAX parameter tree over to the port's models.

The JAX package's decoder ``init_params`` returns ``{"embed", "prologue",
"slots", "final_norm"}`` with each pattern slot's blocks stacked over a
leading (reps, ...) axis; its encoder-decoder returns ``{"embed",
"encoder", "enc_norm", "decoder", "final_norm"}`` with the layers stacked
over a leading (L, ...) axis.  Given either tree as numpy arrays
(``jax.tree.map(np.asarray, params)``), `from_jax_params` writes each
array into the matching parameter of a `Transformer` or `EncDec`, so both
packages compute with the same weights.  Decoder layer ``n_pro + r *
period + j`` is ``slots[j]`` at repetition ``r`` (Jamba: period 8).  A
MoE layer's ``ffn`` carries its stacked experts, the router and
``shared``; an MLA mixer its ``wkv_a`` / ``kv_norm`` / ``wkv_b`` /
``wq_a`` / ``q_norm`` / ``wq_b`` (or ``wq``) / ``wo``; an SSD mixer
``w_in`` / ``conv_w`` / ``conv_b`` / ``a_log`` / ``d_skip`` / ``dt_bias``
/ ``gate_norm`` / ``w_out``.  Values take the port parameter's dtype, so
the router and ``a_log`` / ``d_skip`` / ``dt_bias`` stay float32 as the
JAX initializers make them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.registry import model_class
from repro_torch.models.transformer import _layout


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = tree


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16: exact through f32
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))   # a writable copy


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def jax_state_dict(cfg, params) -> dict[str, np.ndarray]:
    """The JAX tree as the port's flat ``state_dict`` names -> arrays."""
    flat: dict = {}
    _flatten(params["embed"], "embed.", flat)
    _flatten(params["final_norm"], "final_norm.", flat)
    if cfg.family == "audio":
        _flatten(params["enc_norm"], "enc_norm.", flat)
        for part, n in (("encoder", cfg.encoder_layers),
                        ("decoder", cfg.num_layers)):
            for i in range(n):
                _flatten(_index(params[part], i), f"{part}.{i}.", flat)
        return flat
    n_pro, period, reps = _layout(cfg)
    layers = list(params["prologue"])
    for r in range(reps):
        for j in range(period):
            layers.append(_index(params["slots"][j], r))
    for i, lp in enumerate(layers):
        _flatten(lp, f"layers.{i}.", flat)
    return flat


@torch.no_grad()
def load_state(model: nn.Module, flat: dict) -> nn.Module:
    """Copy flat ``state_dict``-named arrays into ``model`` (every
    parameter, names and shapes checked; values cast to the model's
    parameter dtype)."""
    own = dict(model.named_parameters())
    if set(flat) != set(own):
        raise ValueError(
            f"parameter names differ: only given {sorted(set(flat) - set(own))}"
            f", only in the port {sorted(set(own) - set(flat))}")
    for name, arr in flat.items():
        t = _tensor(arr)
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: given shape {tuple(t.shape)} != port "
                             f"{tuple(own[name].shape)}")
        own[name].copy_(t.to(own[name].dtype))
    return model


def from_jax_params(cfg, params, device=None) -> nn.Module:
    """A `Transformer` (an `EncDec` for the audio family) on ``device``
    holding the JAX tree's weights."""
    return load_state(model_class(cfg)(cfg, device=device, init=False),
                      jax_state_dict(cfg, params))
