"""Dry-run on one card (port of ``repro.launch.dryrun``): count every (arch ×
shape) cell's step on the meta device and record its memory, cost and
roofline in the JAX record's schema.

What JAX does: it lowers each cell against ``ShapeDtypeStruct`` stand-ins
on 512 fake devices, reads XLA's ``memory_analysis()`` /
``cost_analysis()`` and the HLO's collectives, and extrapolates depth
from probes at 1 and 2 pattern repetitions (XLA counts a scan body once).
What the port does: it builds the model on the meta device (shapes, no
memory), takes `models.registry.input_specs`'s meta tensors, and runs
the port's real step on them under `analysis.count.count`:

- train: ``train.make_train_step`` with ``AdamWConfig(state_dtype=
  "bfloat16")`` and ``accum_steps`` (8, as JAX's ``run_cell``);
- prefill: ``api(cfg).prefill``; decode: ``api(cfg).decode_step``.

The layers are a Python list, so the count is taken at full depth and
needs no probe: ``roofline_extrapolated`` is the full-depth count's
roofline with ``probe_reps: []``.  ``flops`` are products only, ``bytes
accessed`` the eager program's per-op traffic (`analysis.count`), the
memory's ``peak_bytes`` arguments plus the step's temporaries, as
``torch.cuda.max_memory_allocated`` reads them.  The constants are the
card's row (`launch.mesh.card`): the card present, or ``--card NAME``
where there is none; with neither the command raises.  Only the mesh
``card1`` (one card) exists: ``pod1`` / ``pod2`` need the multi-card
slice (ROADMAP Queue 1 item 3) and raise.  ``lower_s`` is the host
seconds of building the meta model and inputs, ``compile_s`` those of
the count.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh card1 \\
      --card "NVIDIA H100 80GB HBM3" --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_8b \\
      --shape decode_32k --batch 8 --card "NVIDIA H100 80GB HBM3"
  PYTHONPATH=src python -m repro_torch.analysis.report   # the tables
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis import roofline as R
from repro_torch.analysis.count import count
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as M
from repro_torch.models.registry import (
    SHAPES,
    api,
    input_specs,
    model_class,
    shape_applicable,
)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import make_train_step

MESHES = {"card1": 1}
TRAIN_OPT = AdamWConfig(state_dtype="bfloat16")


def _mesh_chips(mesh: str) -> int:
    if mesh not in MESHES:
        raise NotImplementedError(
            f"mesh {mesh!r} needs more than one card; the port's meshes "
            f"come with the multi-card slice (ROADMAP.md, Queue 1 item 3)")
    return MESHES[mesh]


def step_call(cfg, kind: str, model, inputs: dict, opt: dict | None = None,
              accum_steps: int = 1):
    """The port's step of ``kind`` on ``model`` and ``inputs`` (an
    `input_specs` dict, on any device); returns (a closure running it,
    the tensors alive before it: parameters, buffers, optimizer state,
    inputs).  A train step takes ``opt`` (from `adamw_init` with
    `TRAIN_OPT`)."""
    m = api(cfg)
    held = [list(model.parameters()), list(model.buffers()), inputs]
    if kind == "train":
        step = make_train_step(cfg, TRAIN_OPT, accum_steps=accum_steps)
        return (lambda: step(model, opt, inputs)), held + [opt]
    if kind == "prefill":
        caches = inputs["caches"]
        if cfg.family == "audio":
            fn = lambda: m.prefill(model, inputs["tokens"], inputs["frames"],
                                   caches)
        elif cfg.family == "vlm":
            fn = lambda: m.prefill(model, inputs["tokens"], caches,
                                   vision_embeds=inputs["vision_embeds"])
        else:
            fn = lambda: m.prefill(model, inputs["tokens"], caches)
        return fn, held
    return (lambda: m.decode_step(model, inputs["token"], inputs["caches"],
                                  inputs["length"])), held


def smoke_inputs(cfg, kind: str, device, rows: int, seq: int,
                 max_len: int):
    """(model, inputs, opt) of a small step of ``kind`` on ``device``, for
    `step_call`: the model's seed-0 weights (none on meta), token ids and
    frame or vision embeddings 0, ``rows`` × ``seq`` tokens (a VLM's
    ``seq`` counts its vision tokens), caches of ``max_len`` tokens, a
    decode's every row at length ``seq``; a train step's ``opt`` from
    `adamw_init` with `TRAIN_OPT`."""
    model = model_class(cfg)(cfg, device=device, init=device != "meta")
    act = getattr(torch, cfg.dtype)

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    s_text = seq - cfg.vision_tokens if cfg.family == "vlm" else seq
    inputs = {"tokens": z(rows, s_text)}
    if cfg.family == "vlm":
        inputs["vision_embeds"] = z(rows, cfg.vision_tokens, cfg.d_model,
                                    dtype=act)
    if cfg.family == "audio":
        inputs["frames"] = z(rows, cfg.encoder_seq, cfg.d_model, dtype=act)
    opt = None
    if kind == "train":
        inputs["labels"] = z(rows, s_text)
        opt = adamw_init(TRAIN_OPT, dict(model.named_parameters()))
    elif kind == "prefill":
        inputs["caches"] = api(cfg).init_caches(rows, max_len, device)
    else:
        inputs = {"token": z(rows, 1),
                  "length": torch.full((rows,), seq, dtype=torch.int32,
                                       device=device),
                  "caches": api(cfg).init_caches(rows, max_len, device)}
    return model, inputs, opt


def _skipped(arch, shape_name, mesh, why):
    return {"arch": arch, "shape": shape_name, "mesh": mesh,
            "status": "skipped", "reason": why}


def lower_cell(arch: str, shape_name: str, mesh: str = "card1",
               extra_cfg: dict | None = None, accum_steps: int = 1,
               batch_override: int | None = None, card: str | None = None):
    """Count one cell on the meta device.  Returns (record, `Count`);
    (record, None) for a cell `shape_applicable` skips."""
    spec = M.card(card)
    cfg = get_config(arch)
    if extra_cfg:
        cfg = dataclasses.replace(cfg, **extra_cfg)
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        return _skipped(arch, shape_name, mesh, why), None

    n_chips = _mesh_chips(mesh)
    t0 = time.time()
    kind, specs = input_specs(cfg, shape_name, batch_override)
    seq, gbatch, _ = SHAPES[shape_name]
    b = batch_override or gbatch
    model = model_class(cfg)(cfg, device="meta", init=False)
    n_params = model.param_count()
    n_active = R.active_params(cfg, n_params)
    opt = (adamw_init(TRAIN_OPT, dict(model.named_parameters()))
           if kind == "train" else None)
    fn, held = step_call(cfg, kind, model, specs, opt, accum_steps)
    n_tokens = b if kind == "decode" else b * seq
    t_lower = time.time() - t0
    t0 = time.time()
    _, c = count(fn, held, device="meta")
    t_count = time.time() - t0

    cost = {"flops": float(c.flops), "bytes accessed": float(c.bytes)}
    coll = R.no_collectives()
    mf = R.model_flops(cfg, kind, n_tokens, n_params, n_active)
    rf = R.roofline_terms(cost, coll, mf, n_chips, spec)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh,
        "status": "ok",
        "step_kind": kind,
        "card": spec.name,
        "n_chips": n_chips,
        "n_params": n_params,
        "n_active_params": n_active,
        "n_tokens_global": n_tokens,
        "batch": b,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_count, 2),
        "ops": c.ops,
        "memory": {
            "argument_size_bytes": c.argument_bytes,
            "output_size_bytes": c.output_bytes,
            "temp_size_bytes": c.temp_bytes,
            "peak_bytes": c.peak_bytes,
        },
        "cost_analysis": cost,
        "flops_counted": "products only (FlopCounterMode's formulas)",
        "collectives": coll,
        "roofline": rf.as_dict(),
        "accum_steps": accum_steps,
    }
    return rec, c


def run_cell(arch: str, shape_name: str, mesh: str = "card1",
             accum_steps: int = 8, extra_cfg: dict | None = None,
             batch_override: int | None = None, card: str | None = None):
    """`lower_cell` at full depth (a train step with ``accum_steps``, other
    kinds with 1), with ``roofline_extrapolated`` taken from that count:
    no probe is needed where the layers are a list."""
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        return _skipped(arch, shape_name, mesh, why)
    accum = accum_steps if SHAPES[shape_name][2] == "train" else 1
    rec, _ = lower_cell(arch, shape_name, mesh, extra_cfg=extra_cfg,
                        accum_steps=accum, batch_override=batch_override,
                        card=card)
    rf = rec["roofline"]
    rec["roofline_extrapolated"] = {
        "flops": rf["flops"],
        "hbm_bytes": rf["hbm_bytes"],
        "wire_bytes": rf["wire_bytes"],
        "compute_s": rf["compute_s"],
        "memory_s": rf["memory_s"],
        "collective_s": rf["collective_s"],
        "bottleneck": rf["bottleneck"],
        "model_flops_per_device": rf["model_flops_per_device"],
        "useful_flops_ratio": rf["useful_flops_ratio"],
        "probe_reps": [],
        "reps_full": (cfg.num_layers - cfg.dense_layers) // cfg.pattern_period,
    }
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="card1", choices=["card1", "pod1",
                                                        "pod2"])
    ap.add_argument("--card", default=None,
                    help="the card's row in launch.mesh.CARDS (default: the "
                         "card present; with no card this is required)")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch_override: rows of the shape's global batch")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    _mesh_chips(args.mesh)
    card = M.card(args.card).name
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    cells = [(a, s) for a in archs for s in shapes]
    errors = 0
    for arch, shape_name in cells:
        tag = f"{arch.replace('.', '_')}__{shape_name}__{args.mesh}"
        fp = outdir / f"{tag}.json"
        if fp.exists() and not args.force:
            print(f"[skip existing] {tag}")
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            rec = run_cell(arch, shape_name, args.mesh,
                           batch_override=args.batch, card=card)
            if rec["status"] == "ok":
                rx, mem = rec["roofline_extrapolated"], rec["memory"]
                print(f"  count {rec['compile_s']}s  "
                      f"flops/dev {rx['flops']:.3e}  "
                      f"bytes/dev {rx['hbm_bytes']:.3e}  "
                      f"bottleneck {rx['bottleneck']}  "
                      f"useful {rx['useful_flops_ratio']:.2f}")
                print(f"  peak {mem['peak_bytes'] / 1e9:.2f} GB of "
                      f"{M.card(card).HBM_PER_CHIP / 1e9:.0f} (args "
                      f"{mem['argument_size_bytes']} temp "
                      f"{mem['temp_size_bytes']})")
            else:
                print(f"  SKIPPED: {rec['reason']}")
        except Exception as e:  # record the failure; the sweep continues
            errors += 1
            rec = {"arch": arch, "shape": shape_name, "mesh": args.mesh,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            print(f"  ERROR: {rec['error']}")
        fp.write_text(json.dumps(rec, indent=1))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
