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

``input_specs(cfg, shape_name)`` returns meta-device stand-ins for every
input of the step a shape runs (train step / prefill / decode step), as
the JAX function returns ``ShapeDtypeStruct``s; the dry-run
(`launch.dryrun`) counts the step against exactly these.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.basic import dtype_of

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


def input_specs(cfg: ModelConfig, shape_name: str,
                batch_override: int | None = None):
    """Meta tensors for the step the shape runs, with the JAX function's
    keys, shapes and dtypes; returns (step_kind, specs).  The caches are
    the port's own (`init_caches` on the meta device: a list of per-layer
    dicts, or the encoder-decoder's L-stacked dict), which hold JAX's
    leaves layer by layer.  Allocates nothing and touches no card."""
    seq, gbatch, kind = SHAPES[shape_name]
    b = batch_override or gbatch
    i32 = torch.int32
    act = dtype_of(cfg.dtype)

    def S(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind == "train":
        if cfg.family == "vlm":
            st = seq - cfg.vision_tokens
            specs = {
                "tokens": S((b, st), i32),
                "labels": S((b, st), i32),
                "vision_embeds": S((b, cfg.vision_tokens, cfg.d_model), act),
            }
        elif cfg.family == "audio":
            specs = {
                "tokens": S((b, seq), i32),
                "labels": S((b, seq), i32),
                "frames": S((b, cfg.encoder_seq, cfg.d_model), act),
            }
        else:
            specs = {"tokens": S((b, seq), i32), "labels": S((b, seq), i32)}
        return "train", specs

    mod = encdec if cfg.family == "audio" else transformer
    cache_spec = mod.init_caches(cfg, b, seq, "meta")

    if kind == "prefill":
        if cfg.family == "vlm":
            specs = {
                "tokens": S((b, seq - cfg.vision_tokens), i32),
                "vision_embeds": S((b, cfg.vision_tokens, cfg.d_model), act),
                "caches": cache_spec,
            }
        elif cfg.family == "audio":
            specs = {
                "tokens": S((b, seq), i32),
                "frames": S((b, cfg.encoder_seq, cfg.d_model), act),
                "caches": cache_spec,
            }
        else:
            specs = {"tokens": S((b, seq), i32), "caches": cache_spec}
        return "prefill", specs

    # decode: one new token against a seq-long cache
    specs = {
        "token": S((b, 1), i32),
        "length": S((b,), i32),
        "caches": cache_spec,
    }
    return "decode", specs
