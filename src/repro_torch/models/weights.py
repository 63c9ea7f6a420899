"""Carry a JAX parameter tree over to the port's `Transformer`.

The JAX package's ``init_params`` returns ``{"embed", "prologue", "slots",
"final_norm"}`` with each pattern slot's blocks stacked over a leading
(reps, ...) axis.  Given that tree as numpy arrays (``jax.tree.map(
np.asarray, params)``), `from_jax_params` writes each array into the
matching parameter, so both packages compute with the same weights.  Layer
``n_pro + r * period + j`` is ``slots[j]`` at repetition ``r``.  A MoE
layer's ``ffn`` carries its stacked experts (``w_gate`` / ``w_up`` /
``w_down``, (E, ...)), the router and ``shared``; values take the port
parameter's dtype, so the router stays float32 as ``init_moe`` makes it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import Transformer, _layout


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


def jax_state_dict(cfg, params) -> dict[str, np.ndarray]:
    """The JAX tree as the port's flat ``state_dict`` names -> arrays."""
    n_pro, period, reps = _layout(cfg)
    layers = list(params["prologue"])
    for r in range(reps):
        for j in range(period):
            layers.append(_index(params["slots"][j], r))
    flat: dict = {}
    _flatten(params["embed"], "embed.", flat)
    _flatten(params["final_norm"], "final_norm.", flat)
    for i, lp in enumerate(layers):
        _flatten(lp, f"layers.{i}.", flat)
    return flat


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


@torch.no_grad()
def load_state(model: Transformer, flat: dict) -> Transformer:
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


def from_jax_params(cfg, params, device=None) -> Transformer:
    """A `Transformer` on ``device`` holding the JAX tree's weights."""
    return load_state(Transformer(cfg, device=device, init=False),
                      jax_state_dict(cfg, params))
