#!/usr/bin/env python3
"""Where a decoder's prefill + decode steps drift from its ``forward_train``
over the same tokens: per step (the logits) and per layer (the residual
stream after each block), on one card.

    python3 tools/decode_drift.py [--arch mamba2_370m] [--dtype bfloat16]
        [--layers N] [--batch 4] [--prompt 8192] [--steps 64] [--seed 0]
        [--ckpt DIR]

The model is ``arch``'s full config (``--layers`` cuts its depth) with
weights drawn on the card from ``--seed`` (`registry.api`), in ``--dtype``;
with ``--ckpt`` the weights of the latest checkpoint the trainer wrote
there (``python -m repro_torch.launch.train --arch A --ckpt-dir DIR``)
replace them.
It runs ``forward_train`` over batch x (prompt + steps) seeded tokens, then
a prefill of the prompt and ``steps`` decode steps fed the next tokens,
recording every block's output at the prompt's last position and at each
decoded one.  Prints one JSON object: the largest |logit|, each position's
largest logit difference (``step_err``: the prefill's, then each step's),
the share of argmaxes equal, and each layer's largest difference over its
largest |value| (``prefill_layer_rel``; ``decode_layer_rel`` at the first,
middle and last step).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def drift(arch: str, dtype: str, layers: int | None, b: int, s0: int,
          steps: int, seed: int, device: str = "cuda",
          ckpt: str | None = None) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import blocks as B
    from repro_torch.models.registry import api

    cfg = dataclasses.replace(get_config(arch), dtype=dtype,
                              param_dtype=dtype,
                              num_layers=layers or get_config(arch).num_layers)
    dev = torch.device(device)
    model = api(cfg).init_params(device=dev, seed=seed)
    ckpt_step = None
    if ckpt is not None:
        from repro_torch.checkpoint import CheckpointManager

        params = dict(model.named_parameters())
        ckpt_step, (saved,), _ = CheckpointManager(ckpt).restore(
            None, (params,), device=dev)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])
        del saved
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, s0 + steps)), dtype=torch.int32, device=dev)
    rec = {"train": [], "prefill": [], "decode": []}
    orig = B.block_train, B.block_prefill, B.block_decode

    def train(layer, cfg, x, *a, **k):
        y = orig[0](layer, cfg, x, *a, **k)
        rec["train"].append(y[:, s0 - 1:].float())
        return y

    def prefill(layer, cfg, x, *a, **k):
        y, c = orig[1](layer, cfg, x, *a, **k)
        rec["prefill"].append(y[:, -1].float())
        return y, c

    def decode(layer, cfg, x, *a, **k):
        y, c = orig[2](layer, cfg, x, *a, **k)
        rec["decode"].append(y[:, 0].float())
        return y, c

    B.block_train, B.block_prefill, B.block_decode = train, prefill, decode
    try:
        with torch.no_grad():
            ref = model.forward_train(toks)
        caches = model.init_caches(b, s0 + steps)
        lg, caches = model.prefill(toks[:, :s0], caches)
        out = [lg[:, 0]]
        for j in range(steps):
            lg, caches = model.decode_step(
                toks[:, s0 + j:s0 + j + 1], caches,
                torch.full((b,), s0 + j, dtype=torch.int32, device=dev))
            out.append(lg[:, 0])
    finally:
        B.block_train, B.block_prefill, B.block_decode = orig
    got, want = torch.stack(out, 1), ref[:, s0 - 1:]

    def rel(a, w) -> float:
        return float((a - w).abs().max() / w.abs().max())

    n = cfg.num_layers
    dec = rec["decode"]
    return dict(
        arch=arch, dtype=dtype, layers=n, batch=b, prompt=s0, steps=steps,
        ckpt_step=ckpt_step,
        device=(torch.cuda.get_device_name(0) if dev.type == "cuda"
                else dev.type),
        max_logit=float(want.abs().max()),
        step_err=(got - want).abs().amax(dim=(0, 2)).tolist(),
        token_match=float((got.argmax(-1) == want.argmax(-1)).float().mean()),
        prefill_layer_rel=[rel(rec["prefill"][i], rec["train"][i][:, 0])
                           for i in range(n)],
        decode_layer_rel={j: [rel(dec[j * n + i], rec["train"][i][:, 1 + j])
                              for i in range(n)]
                          for j in sorted({0, steps // 2, steps - 1})
                          if steps})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2_370m")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="a trainer's checkpoint directory to load")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("decode_drift: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
    print(json.dumps(drift(args.arch, args.dtype, args.layers, args.batch,
                           args.prompt, args.steps, args.seed,
                           ckpt=args.ckpt)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
