"""The train step: gradients of ``loss_fn`` + AdamW, with optional
gradient accumulation (port of ``repro.train.step``), on one device.

``train_step(model, opt_state, batch)`` differentiates the model's
``loss_fn`` with ``torch.autograd.grad`` (the counterpart of
``jax.value_and_grad``: nothing is written to ``.grad``, so nothing
stale accumulates there), then runs `optim.adamw_step_`, which updates the
model's parameters and ``opt_state`` in place, leaf by leaf.  It returns
``(model, opt_state, metrics)`` as the JAX function returns its new trees;
``metrics`` holds 0-d tensors on the device (``loss``, ``grad_norm``,
``lr``), read by nothing inside the step, so the step makes no host sync.

With ``accum_steps = A > 1`` the batch's rows split into A microbatches,
microbatch ``a`` taking rows ``b * A + a`` (JAX reshapes to (B/A, A, ...)
and swaps the axes); losses and gradients add as ``acc + g.float() / A``
into float32 zeros, in microbatch order.  With A = 1 the gradients keep
the parameters' dtype, as JAX's do.

Sharded (DTensor parameters and batch, `repro_torch.parallel`, run under
``logical_rules``): the same step; each gradient is brought to its
parameter's placements by hand (a partial sum over the data rows reduced,
`parallel.ax.redistribute_local`) before the update, and the metrics are
plain 0-d tensors, the same on every rank.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.registry import api
from repro_torch.optim import AdamWConfig, adamw_step_
from repro_torch.parallel.ax import redistribute_local, wrap


def microbatch(batch: dict, accum_steps: int, a: int) -> dict:
    """Microbatch ``a`` of ``accum_steps``: the rows ``b * accum_steps +
    a`` of every leaf."""
    return {k: v.reshape((v.shape[0] // accum_steps, accum_steps)
                         + tuple(v.shape[1:]))[:, a].contiguous()
            for k, v in batch.items()}


def _laid_out_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Gradient ``g`` in the placements of its parameter ``p``."""
    if not isinstance(g, DTensor) or tuple(g.placements) == \
            tuple(p.placements):
        return g
    loc = redistribute_local(g._local_tensor, g.device_mesh, g.placements,
                             p.placements)
    return wrap(loc, g.device_mesh, p.placements, g.shape)


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A replicated 0-d DTensor's value as a plain tensor."""
    return t._local_tensor if isinstance(t, DTensor) else t


def make_train_step(cfg, ocfg: AdamWConfig, accum_steps: int = 1):
    m = api(cfg)

    def grads_of(model, params, batch):
        loss = m.loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params)
        return (_plain(loss.detach()),
                [_laid_out_as(g, p) for g, p in zip(grads, params)])

    def train_step(model, opt_state, batch):
        named = dict(model.named_parameters())
        params = list(named.values())
        for p in params:
            p.requires_grad_(True)
        if accum_steps == 1:
            loss, grads = grads_of(model, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     if isinstance(p, DTensor) else
                     torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in params]
            for a in range(accum_steps):
                lo, gs = grads_of(model, params,
                                  microbatch(batch, accum_steps, a))
                loss = loss + lo / accum_steps
                for acc, g in zip(grads, gs):
                    acc.add_(g.float() / accum_steps)
                del gs
        metrics = adamw_step_(ocfg, named, dict(zip(named, grads)),
                              opt_state)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step
