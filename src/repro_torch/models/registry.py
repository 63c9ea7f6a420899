"""Model facade and the assignment's shapes (port of
``repro.models.registry``).

``api(cfg)`` gives one interface whatever the family, with the JAX
facade's fields; the port's parameters are the model module, so where a
JAX function takes ``params`` these take the model ``init_params`` made:

    init_params(device=None, generator=None, seed=0) -> model
    loss_fn(model, batch) / forward_train(model, **inputs)
    prefill(model, ...) / decode_step(model, ...)
    init_caches(batch, max_len, device=None)
    module                                  -> transformer or encdec

The audio family runs `encdec`, every other family `transformer`.
``input_specs`` (the JAX dry-run's shape stand-ins) is not here: its only
caller, ``launch/dryrun.py``, is not ported.
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig

# assignment shape table: name -> (seq_len, global_batch, step kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """Per-assignment skips: long_500k needs sub-quadratic attention."""
    if shape_name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("long_500k skipped: pure full-attention arch "
                       "(per assignment)")
    return True, ""


def model_class(cfg: ModelConfig):
    """`encdec.EncDec` for the audio family, else `transformer.Transformer`."""
    return encdec.EncDec if cfg.family == "audio" else transformer.Transformer


def api(cfg: ModelConfig) -> SimpleNamespace:
    mod = encdec if cfg.family == "audio" else transformer
    cls = model_class(cfg)
    return SimpleNamespace(
        init_params=lambda device=None, generator=None, seed=0: cls(
            cfg, device=device, generator=generator, seed=seed),
        loss_fn=lambda model, batch: model.loss_fn(batch),
        forward_train=lambda model, **kw: model.forward_train(**kw),
        prefill=lambda model, *a, **kw: model.prefill(*a, **kw),
        decode_step=lambda model, *a, **kw: model.decode_step(*a, **kw),
        init_caches=lambda batch, max_len, device=None: mod.init_caches(
            cfg, batch, max_len, device),
        module=mod,
    )
