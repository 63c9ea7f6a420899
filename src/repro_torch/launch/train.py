"""End-to-end training entry point (port of ``repro.launch.train``), on
one device or sharded over a ("data", "model") mesh of processes.

What runs: AdamW + cosine schedule + grad clip + grad accumulation
(`train.make_train_step`), the deterministic-by-step data pipeline with
prefetch (`data.Pipeline`), checkpoint / restart (atomic, async;
`checkpoint.CheckpointManager`) and a SIGTERM trap that checkpoints and
stops.  The model is drawn from seed 0 on the device; the checkpoint tree
is ``(named parameters, {"m", "v", "step"})`` under the port's parameter
names, saved as ``step % ckpt_every == 0``, at SIGTERM and at the last
step with ``extra={"data_step": step + 1}``; ``--resume`` restarts from
the latest one, so a run killed and resumed equals one run through, bit
for bit.  A mesh (``--data`` / ``--model`` > 1) takes a process group of
data x model ranks (under ``torchrun`` with ``--backend``, or one
started first) and runs any family the model runs: the step's family is
the config's, with no list of its own here.

Usage (smoke scale, on the CPU; the second on 4 gloo ranks):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_8b \\
      --smoke --device cpu --steps 20 --batch 8 --seq 128 --ckpt-dir DIR
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch whisper_base --smoke --device cpu --data 2 --model 2 \\
      --backend gloo --steps 8 --batch 8 --seq 32

``main`` returns the model.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import signal
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.deltatree import resolve_device
from repro_torch.data import DataConfig, Pipeline, to_device
from repro_torch.launch import mesh as M
from repro_torch.models.registry import api
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import comm as C
from repro_torch.parallel import shardings as SH
from repro_torch.parallel.ax import logical_rules
from repro_torch.train import make_train_step


def _mesh(args, device):
    """The ("data", "model") mesh, or None for one device; starts the
    process group from torchrun's environment where ``--backend`` names
    one and none is running.  Returns (mesh, started)."""
    n = args.data * args.model
    if n == 1:
        return None, False
    started = False
    if not dist.is_initialized():
        if args.backend is None:
            raise ValueError(
                f"a {args.data} x {args.model} mesh needs {n} ranks of a "
                "process group: run under torchrun with --backend gloo or "
                "nccl, or start the group first")
        M.start_process_group(args.backend)
        started = True
    _, w = M.world()
    if w != n:
        raise ValueError(f"a {args.data} x {args.model} mesh needs {n} "
                         f"ranks; the process group has {w}")
    return M.make_host_mesh(args.data, args.model, device=device), started


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
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="process group backend of a mesh under torchrun")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh, started = _mesh(args, device)
    try:
        return _run(args, device, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, device, mesh):
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    m = api(cfg)
    ocfg = AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=5)
    step_fn = make_train_step(cfg, ocfg, accum_steps=args.accum)
    lead = M.world()[0] == 0

    model = m.init_params(device=device, seed=0)
    shardings = None
    if mesh is not None:
        pspecs = SH.param_specs(model)
        shardings = (SH.to_named(pspecs, mesh),
                     SH.to_named(SH.opt_specs(pspecs), mesh))
        SH.shard_params(model, shardings[0])
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
                                              device=device,
                                              shardings=shardings)
        with torch.no_grad():
            for k, p in params.items():
                SH.local(p).copy_(SH.local(saved[k]))
        if lead:
            print(f"[train] resumed from step {start}")

    stop = {"now": False}
    prev = signal.signal(signal.SIGTERM, lambda *_: stop.update(now=True))
    pipe = Pipeline(dcfg, start_step=start)

    def rules():
        return (logical_rules(mesh) if mesh is not None
                else contextlib.nullcontext())

    t0 = time.time()
    tokens_done = 0
    try:
        for _ in range(start, args.steps):
            step, batch = next(pipe)
            if mesh is None:
                batch = to_device(batch, device)
            else:
                batch = SH.shard_batch(to_device(batch, "cpu"), mesh, device)
            with rules():
                model, opt, metrics = step_fn(model, opt, batch)
            if mesh is not None:
                flag = torch.tensor([float(stop["now"])])
                for k in range(mesh.ndim):
                    if mesh.size(k) > 1:
                        flag = C.all_reduce(flag, mesh.get_group(k), "max")
                stop["now"] = bool(flag.item())
            tokens_done += args.batch * args.seq
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])
                gn = float(metrics["grad_norm"])
                tps = tokens_done / max(time.time() - t0, 1e-9)
                if lead:
                    print(f"[train] step {step:5d} loss {loss:8.4f} "
                          f"gnorm {gn:7.3f} tok/s {tps:9.0f}", flush=True)
                if not math.isfinite(loss):
                    raise FloatingPointError(f"loss diverged at step {step}")
            if ckpt and (step % args.ckpt_every == 0 or stop["now"]
                         or step == args.steps - 1):
                ckpt.save(step + 1, (params, opt),
                          extra={"data_step": step + 1})
            if stop["now"]:
                if lead:
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
