"""PyTorch port: the encoder-decoder (``repro_torch.models.encdec``, the
Whisper smoke model: 2 encoder and 2 decoder layers over 24 frame
embeddings) against the JAX package's, with the JAX weights carried over,
in float32.

Each leg holds ``forward_train`` logits, ``loss_fn``, the prefill logits
and the L-stacked caches (self-attention ``k`` / ``v``, cross-attention
``ck`` / ``cv``), and 8 decode steps' logits and caches within TOL of
JAX.  A second leg turns on ``qkv_bias`` with the biases drawn at random
(JAX inits them to zeros), so a bias left out of the cross query or keys
shows.  The JAX side runs once per test run.
"""

import numpy as np
import pytest
import torch

from _torch_parity import (
    check_model_leg,
    few_jax_executables,  # noqa: F401  (autouse)
    jax_model_leg,
    port_model,
)

TOL = 1e-5
ARCH = "whisper_base"
LEGS = {"published": {}, "qkv_bias": {"qkv_bias": True}}


@pytest.fixture(scope="module")
def jax_whisper(tmp_path_factory):
    # the published leg's record is shared with test_torch_models.py
    return {leg: jax_model_leg(tmp_path_factory, ARCH,
                               f"model_{ARCH}_{leg}" if kw else None,
                               random_biases=bool(kw), **kw)
            for leg, kw in LEGS.items()}


@pytest.mark.parametrize("phase", ["train", "prefill", "decode"])
@pytest.mark.parametrize("leg", list(LEGS))
def test_whisper_equals_jax(jax_whisper, leg, phase):
    check_model_leg(jax_whisper[leg], ARCH, phase, TOL, **LEGS[leg])


def test_prefill_refuses_other_frame_counts(jax_whisper):
    """The cross caches hold ``encoder_seq`` frames: a prefill over
    another count raises, naming both."""
    rec = jax_whisper["published"]
    model = port_model(rec, ARCH)
    frames = torch.as_tensor(rec["frames"][:, :-1])
    with pytest.raises(ValueError, match="23 frames"):
        model.prefill(torch.as_tensor(rec["tokens"][:, :4]), frames,
                      model.init_caches(2, 8))
    assert np.isfinite(model.encode(frames).numpy()).all()
