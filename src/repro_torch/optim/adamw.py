"""AdamW with global-norm clipping and a cosine schedule (port of
``repro.optim.adamw``).

The arithmetic is the JAX function's, cast for cast: the clip scale
``min(1, clip / max(|g|, 1e-9))``, bias-corrected moments, the decoupled
decay ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` on every leaf
(norms and the embedding included), and ``lr``, the corrections ``c1`` /
``c2`` and the scale as float32 tensors on the device from the int32 step
(``torch.optim.AdamW`` and ``clip_grad_norm_`` round differently).  The
moment dtype is configurable: bf16 moments halve the optimizer's memory
(every leaf's math stays float32 and is rounded once on store).

Parameters, gradients and moments are dicts of tensors (name -> tensor).
`adamw_step_` updates the parameters and the state in place, leaf by
leaf, so only one leaf's float32 temporaries are alive at a time (a whole
tree's would not fit beside a full-width model);  `adamw_update` is the
functional form of the same code, for trees the caller keeps.

Sharded leaves (DTensors, `repro_torch.parallel`): the moments are made
beside each parameter's block with its placements, the norm is over every
block of every leaf (each rank's sum of squares, a replicated leaf's
divided by its copies, summed over the mesh), and each rank updates its
blocks in place with the same arithmetic.  The gradients must be laid out
as their parameters (`train.make_train_step` sees to it).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.parallel import comm as C
from repro_torch.parallel.ax import axis_of


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # "bfloat16" for the huge archs
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _state_dtype(cfg: AdamWConfig) -> torch.dtype:
    try:
        return _STATE_DTYPES[cfg.state_dtype]
    except KeyError:
        raise ValueError(f"unsupported state_dtype {cfg.state_dtype!r}") \
            from None


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine to ``min_lr_frac * lr`` at
    ``total_steps``; ``step`` an integer tensor (or int), the result a
    float32 tensor on its device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                           1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(cfg: AdamWConfig, params: dict) -> dict:
    """Zero moments in ``cfg.state_dtype`` beside each parameter and an
    int32 step counter on the parameters' device."""
    dt = _state_dtype(cfg)
    device = next(iter(params.values())).device

    def zeros(p):
        if isinstance(p, DTensor):
            return torch.zeros_like(p, dtype=dt)
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {
        "m": {k: zeros(p) for k, p in params.items()},
        "v": {k: zeros(p) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def global_norm(grads) -> torch.Tensor:
    """The float32 norm over every leaf of ``grads`` (a dict or a
    sequence of tensors); over every block of sharded leaves (a plain
    0-d tensor, the same on every rank)."""
    leaves = list(grads.values() if isinstance(grads, dict) else grads)
    sharded = [g for g in leaves if isinstance(g, DTensor)]
    if not sharded:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in leaves))
    if len(sharded) != len(leaves):
        raise ValueError("a mix of sharded and plain gradients")
    mesh = sharded[0].device_mesh
    total = 0
    for g in sharded:
        copies = 1
        for k, p in enumerate(g.placements):
            if isinstance(p, Replicate):
                copies *= mesh.size(k)
            elif not p.is_shard():
                raise ValueError(f"a gradient laid out as {g.placements}")
        total = total + torch.sum(torch.square(g._local_tensor.float())) \
            / copies
    for k in range(mesh.ndim):
        n, _, group = axis_of(mesh, k)
        if n > 1:
            total = C.all_reduce(total, group)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_step_(cfg: AdamWConfig, params: dict, grads: dict,
                state: dict) -> dict:
    """One AdamW step in place: ``params`` and ``state``'s moments and step
    counter change; returns the metrics ``grad_norm`` and ``lr`` (0-d
    float32 tensors on the device).  No host sync."""
    state["step"].add_(1)
    step = state["step"].to(torch.float32)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = cosine_lr(cfg, state["step"])
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - torch.pow(b1, step)
    c2 = 1 - torch.pow(b2, step)
    for k, p in params.items():
        p, m, v = _local(p), _local(state["m"][k]), _local(state["v"][k])
        g = _local(grads[k]).float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        del g
        delta = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        m.copy_(m32)
        v.copy_(v32)
        del m32, v32
        pf = p.float()
        delta = delta + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    return {"grad_norm": gnorm, "lr": lr}


def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict):
    """Returns (new_params, new_state, metrics), leaving the arguments as
    they were (`adamw_step_` on copies)."""
    params = {k: p.detach().clone() for k, p in params.items()}
    state = {"m": {k: t.clone() for k, t in state["m"].items()},
             "v": {k: t.clone() for k, t in state["v"].items()},
             "step": state["step"].clone()}
    metrics = adamw_step_(cfg, params, grads, state)
    return params, state, metrics
