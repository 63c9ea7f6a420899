"""Dry-run (port of ``repro.launch.dryrun``): count every (arch × shape ×
mesh) cell's step on the meta device and record its memory, cost and
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
where there is none; with neither the command raises.  ``lower_s`` is
the host seconds of building the meta model and inputs, ``compile_s``
those of the count.

Meshes: ``card1`` is one card.  ``pod1`` / ``pod2`` are JAX's production
meshes (`launch.mesh.make_production_mesh`: 16 x 16 ("data", "model"),
2 x 16 x 16 ("pod", "data", "model")) over a fake process group of 256 /
512 ranks of which this process is rank 0
(`launch.mesh.fake_process_group`): a CPU mesh whose blocks lie on the
meta device (DTensor's sharding propagation asks a meta mesh for a
device count it has not).  The parameters, optimizer state,
batch and caches are placed by JAX's specs (`place`), so each leaf is
rank 0's block, and the step runs under ``logical_rules`` with DTensor's
own collectives forbidden (the count raises on one).
The count is rank 0's: ``flops``, ``bytes accessed`` and the memory are
per device, as JAX's post-SPMD numbers are, and ``collectives`` is
`analysis.roofline.collective_stats` of the step's `parallel.comm`
records, so the roofline's collective term is wire bytes over the card
row's ``ICI_BW`` (NVLink's), as JAX puts all of them over one ICI
bandwidth.  A "pod" axis across hosts would run over the network, not
NVLink; the row has no second bandwidth, as JAX's has none.
`mesh_count` is the same count on any mesh (a host mesh of a real group
too), which is how the tests and ``chip_smoke.py`` hold the dry-run to
real ranks.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh card1 \\
      --card "NVIDIA H100 80GB HBM3" --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_8b \\
      --shape decode_32k --batch 8 --card "NVIDIA H100 80GB HBM3"
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_8b \\
      --shape decode_32k --mesh pod1 --card "NVIDIA H100 80GB HBM3"
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
from repro_torch.parallel import shardings as SH
from repro_torch.parallel.ax import logical_rules
from repro_torch.train import make_train_step

MESHES = {"card1": 1, "pod1": 256, "pod2": 512}
TRAIN_OPT = AdamWConfig(state_dtype="bfloat16")


def _mesh_chips(mesh: str) -> int:
    if mesh not in MESHES:
        raise ValueError(f"unknown mesh {mesh!r}; known: {sorted(MESHES)}")
    return MESHES[mesh]


def step_call(cfg, kind: str, model, inputs: dict, opt: dict | None = None,
              accum_steps: int = 1, ocfg: AdamWConfig = TRAIN_OPT):
    """The port's step of ``kind`` on ``model`` and ``inputs`` (an
    `input_specs` dict, on any device); returns (a closure running it,
    the tensors alive before it: parameters, buffers, optimizer state,
    inputs).  A train step takes ``opt`` (from `adamw_init` with
    ``ocfg``)."""
    m = api(cfg)
    held = [list(model.parameters()), list(model.buffers()), inputs]
    if kind == "train":
        step = make_train_step(cfg, ocfg, accum_steps=accum_steps)
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


def place(kind: str, model, inputs: dict, mesh,
          ocfg: AdamWConfig = TRAIN_OPT):
    """``model``'s parameters placed by ``param_specs`` on ``mesh`` (in
    place), and (the inputs placed: a batch leaf of rank >= 2 by
    ``batch_spec``, the caches by ``cache_specs``, the rest whole; a
    train step's optimizer state from `adamw_init` with ``ocfg`` over the
    placed parameters, so laid out by ``opt_specs``, else None).  The
    blocks stay on the model's device (meta on a CPU mesh for the
    dry-run)."""
    SH.shard_params(model, SH.to_named(SH.param_specs(model), mesh))
    device = model.device
    out = {}
    for k, v in inputs.items():
        if k == "caches":
            out[k] = SH.shard_state(v, SH.to_named(SH.cache_specs(v, mesh),
                                                   mesh), device)
        else:
            out.update(SH.shard_batch({k: v}, mesh, device))
    opt = (adamw_init(ocfg, dict(model.named_parameters()))
           if kind == "train" else None)
    return out, opt


def mesh_count(cfg, kind: str, model, inputs: dict, mesh,
               ocfg: AdamWConfig = TRAIN_OPT, accum_steps: int = 1,
               live: bool = True):
    """`place` the step on ``mesh`` and count it on this rank
    (`analysis.count.count` over the mesh's device type) under
    ``logical_rules``, with DTensor's own collectives forbidden.  Returns
    the `Count`, its ``collectives`` the step's `parallel.comm`
    records."""
    inputs, opt = place(kind, model, inputs, mesh, ocfg)
    fn, held = step_call(cfg, kind, model, inputs, opt, accum_steps, ocfg)
    with logical_rules(mesh):        # the count forbids DTensor's own
        _, c = count(fn, held, live=live, device=model.device.type)
    return c


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
    if mesh == "card1":
        rec, c = _count_cell(cfg, shape_name, None, accum_steps,
                             batch_override)
    else:
        with M.fake_process_group(n_chips):
            dm = M.make_production_mesh(multi_pod=mesh == "pod2",
                                        device="cpu")
            rec, c = _count_cell(cfg, shape_name, dm, accum_steps,
                                 batch_override)
    kind, n_tokens = rec["step_kind"], rec["n_tokens_global"]
    cost = {"flops": float(c.flops), "bytes accessed": float(c.bytes)}
    coll = R.collective_stats(c.collectives)
    mf = R.model_flops(cfg, kind, n_tokens, rec["n_params"],
                       rec["n_active_params"])
    rf = R.roofline_terms(cost, coll, mf, n_chips, spec)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh,
        "status": "ok",
        "step_kind": kind,
        "card": spec.name,
        "n_chips": n_chips,
        **{k: rec[k] for k in ("n_params", "n_active_params",
                               "n_tokens_global", "batch", "lower_s",
                               "compile_s")},
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


def _count_cell(cfg, shape_name: str, mesh, accum_steps: int,
                batch_override: int | None):
    """(the record's step fields, the `Count`) of a cell on the meta
    device: on one card with ``mesh`` None, else placed on ``mesh``."""
    t0 = time.time()
    kind, specs = input_specs(cfg, shape_name, batch_override)
    seq, gbatch, _ = SHAPES[shape_name]
    b = batch_override or gbatch
    model = model_class(cfg)(cfg, device="meta", init=False)
    n_params = model.param_count()
    rec = {"step_kind": kind, "n_params": n_params,
           "n_active_params": R.active_params(cfg, n_params),
           "n_tokens_global": b if kind == "decode" else b * seq,
           "batch": b}
    if mesh is None:
        opt = (adamw_init(TRAIN_OPT, dict(model.named_parameters()))
               if kind == "train" else None)
        fn, held = step_call(cfg, kind, model, specs, opt, accum_steps)
        rec["lower_s"] = round(time.time() - t0, 2)
        t0 = time.time()
        _, c = count(fn, held, device="meta")
    else:
        rec["lower_s"] = round(time.time() - t0, 2)
        t0 = time.time()
        c = mesh_count(cfg, kind, model, specs, mesh,
                       accum_steps=accum_steps)
    rec["compile_s"] = round(time.time() - t0, 2)
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
