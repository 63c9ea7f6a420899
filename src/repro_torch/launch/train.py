"""End-to-end training entry point on one device (port of
``repro.launch.train`` without its mesh).

What runs: AdamW + cosine schedule + grad clip + grad accumulation
(`train.make_train_step`), the deterministic-by-step data pipeline with
prefetch (`data.Pipeline`), checkpoint / restart (atomic, async;
`checkpoint.CheckpointManager`) and a SIGTERM trap that checkpoints and
stops.  The model is drawn from seed 0 on the device; the checkpoint tree
is ``(named parameters, {"m", "v", "step"})`` under the port's parameter
names, saved as ``step % ckpt_every == 0``, at SIGTERM and at the last
step with ``extra={"data_step": step + 1}``; ``--resume`` restarts from
the latest one, so a run killed and resumed equals one run through, bit
for bit.  A mesh (``--data`` / ``--model`` > 1) needs more than one card
and raises.

Usage (smoke scale, on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_8b \\
      --smoke --device cpu --steps 20 --batch 8 --seq 128 --ckpt-dir DIR

``main`` returns the model.
"""

from __future__ import annotations

import argparse
import math
import signal
import time

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.deltatree import resolve_device
from repro_torch.data import DataConfig, Pipeline, to_device
from repro_torch.models.registry import api
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data", type=int, default=1, help="data mesh axis")
    ap.add_argument("--model", type=int, default=1, help="model mesh axis")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.data > 1 or args.model > 1:
        raise ValueError(
            f"a {args.data} x {args.model} mesh needs the multi-card trainer "
            f"(ROADMAP Queue 1 item 3); this one runs on one device (1 x 1)")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    m = api(cfg)
    ocfg = AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=5)
    step_fn = make_train_step(cfg, ocfg, accum_steps=args.accum)

    model = m.init_params(device=device, seed=0)
    params = dict(model.named_parameters())
    opt = adamw_init(ocfg, params)
    dcfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, family=cfg.family, d_model=cfg.d_model,
        vision_tokens=cfg.vision_tokens, encoder_seq=cfg.encoder_seq,
    )
    start = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and latest_step(args.ckpt_dir) is not None:
        start, (saved, opt), _ = ckpt.restore(None, (params, opt),
                                              device=device)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])
        print(f"[train] resumed from step {start}")

    stop = {"now": False}
    prev = signal.signal(signal.SIGTERM, lambda *_: stop.update(now=True))
    pipe = Pipeline(dcfg, start_step=start)
    t0 = time.time()
    tokens_done = 0
    try:
        for _ in range(start, args.steps):
            step, batch = next(pipe)
            model, opt, metrics = step_fn(model, opt,
                                          to_device(batch, device))
            tokens_done += args.batch * args.seq
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])
                gn = float(metrics["grad_norm"])
                tps = tokens_done / max(time.time() - t0, 1e-9)
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"gnorm {gn:7.3f} tok/s {tps:9.0f}", flush=True)
                if not math.isfinite(loss):
                    raise FloatingPointError(f"loss diverged at step {step}")
            if ckpt and (step % args.ckpt_every == 0 or stop["now"]
                         or step == args.steps - 1):
                ckpt.save(step + 1, (params, opt),
                          extra={"data_step": step + 1})
            if stop["now"]:
                print("[train] SIGTERM: checkpointed and exiting")
                break
    finally:
        pipe.close()
        signal.signal(signal.SIGTERM, prev)
        if ckpt:
            ckpt.wait()
    return model


if __name__ == "__main__":
    main()
