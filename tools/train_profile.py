#!/usr/bin/env python3
"""Where a train step's time goes on one card: the port's trainer
(``repro_torch.train.make_train_step``) on ``arch``'s full config, one
``batch_at_step`` row of ``--seq`` tokens a step.

    python3 tools/train_profile.py [--arch granite_8b] [--layers N]
        [--seq 4096] [--steps 4] [--state-dtype bfloat16] [--seed 0]

Weights are drawn on the card from ``--seed`` (bf16, the config's
``remat``).  After one untimed step it times ``--steps`` steps whole,
then the two halves of a step apart (each ending in a synchronize): the
gradients (``loss_fn`` forward, the remat recompute and the backward,
``torch.autograd.grad``) and the AdamW update (`optim.adamw_step_`), then
traces one step with ``torch.profiler``: the device time by kernel class
(GEMMs, softmax-like, reductions, copies, elementwise, the rest), the top
kernels, kernel launches, and the idle share (1 - device busy / the
traced step's wall time).  Prints one JSON object with
the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CLASSES = (  # (class, substrings of a kernel's name), first match wins
    ("gemm", ("nvjet", "gemm", "splitk", "xmma", "cutlass", "cublas")),
    ("softmax_like", ("softmax", "logsumexp")),
    ("reduce", ("reduce", "norm")),
    ("copy", ("copy", "memcpy", "memset", "cat", "index")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def profile(arch: str, layers: int | None, seq: int, steps: int,
            state_dtype: str, seed: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_at_step, to_device
    from repro_torch.models.registry import api
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_step_
    from repro_torch.train import make_train_step

    dev = torch.device("cuda")
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    ocfg = AdamWConfig(state_dtype=state_dtype)
    m = api(cfg)
    model = m.init_params(device=dev, seed=seed)
    named = dict(model.named_parameters())
    opt = adamw_init(ocfg, named)
    step = make_train_step(cfg, ocfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=1, seed=seed, family=cfg.family,
                      d_model=cfg.d_model, vision_tokens=cfg.vision_tokens,
                      encoder_seq=cfg.encoder_seq)
    batches = [to_device(batch_at_step(dcfg, k), dev)
               for k in range(steps + 3)]

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    step(model, opt, batches[0])                       # untimed
    step_ms = [clock(lambda b=b: step(model, opt, b))[0]
               for b in batches[1:steps + 1]]
    params = list(named.values())
    grad_ms, grads = clock(lambda: torch.autograd.grad(
        m.loss_fn(model, batches[steps + 1]), params))
    update_ms, _ = clock(lambda: adamw_step_(
        ocfg, named, dict(zip(named, grads)), opt))
    del grads
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        traced_ms, _ = clock(lambda: step(model, opt, batches[steps + 2]))
    by_class: dict = {}
    by_name: dict = {}
    launches = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        launches += 1
        ms = evt.time_range.elapsed_us() / 1e3
        cls = kernel_class(evt.name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        t, n = by_name.get(evt.name, (0.0, 0))
        by_name[evt.name] = (t + ms, n + 1)
    busy = sum(by_class.values())     # one stream: the busy time
    kernels = sorted(((t, n, k[:120]) for k, (t, n) in by_name.items()),
                     reverse=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return dict(
        arch=arch, layers=cfg.num_layers, seq=seq, remat=cfg.remat,
        remat_policy=cfg.remat_policy, state_dtype=state_dtype,
        params=model.param_count(), card=smi.stdout.strip(),
        step_ms=statistics.median(step_ms), steps_ms=step_ms,
        grad_ms=grad_ms, update_ms=update_ms, traced_step_ms=traced_ms,
        device_busy_ms=busy, idle_share=1 - busy / traced_ms,
        launches=launches, device_ms_by_class=by_class,
        top_kernels=[dict(ms=k[0], count=k[1], name=k[2])
                     for k in kernels[:15]],
        peak_bytes=torch.cuda.max_memory_allocated())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite_8b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--state-dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py 10.2
    print(json.dumps(profile(args.arch, args.layers, args.seq, args.steps,
                             args.state_dtype, args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
