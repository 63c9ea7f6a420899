"""Everything ``tests/test_torch_parallel.py`` counts on a fake process
group, and the JAX legs beside it, in one subprocess (`main`): a fake
group is the process's default group, so it never starts in a pytest
worker.

- the dry-run's meta count of `_torch_parallel_legs.count_leg`'s steps on
  a 4 x 2 mesh of a fake group of 8 (the ranks count the same steps on a
  real group);
- the records of Granite's sharded train step rendered as HLO lines,
  through JAX's ``collective_stats`` and the port's, at group sizes 2,
  16 and 32;
- the production meshes, the port's and ``jax.make_mesh``'s, on 512 host
  devices;
- one pod2 cell per family and step kind (FAKE_CELLS);
- JAX's own pod1 dry-run of a cell, which raises (ROADMAP Queue 3), and
  the port's record of it;
- `parallel.comm.no_functional_collectives` on a DTensor rule that
  communicates.
"""

from __future__ import annotations

import json

import numpy as np

import _torch_parallel_legs as L

CARD = "NVIDIA H100 80GB HBM3"
FAKE_CELLS = (("granite_8b", "train_4k"), ("phi3_5_moe_42b", "decode_32k"),
              ("deepseek_v2_236b", "prefill_32k"),
              ("mamba2_370m", "long_500k"),
              ("jamba_1_5_large_398b", "train_4k"),
              ("whisper_base", "decode_32k"),
              ("internvl2_2b", "prefill_32k"))
# JAX's run_cell probes count with these (the same math, fewer ops)
PROBE = dict(flash_threshold=1 << 30, ssd_vectorized=True)
STATS_GROUPS = (2, 16, 32)
HLO_DTYPE = {"torch.float32": "f32", "torch.bfloat16": "bf16",
             "torch.float16": "f16", "torch.int32": "s32",
             "torch.int64": "s64"}


def one_period(cfg) -> dict:
    """The config override to one pattern period plus the prologue (one
    encoder layer for the encoder-decoder), as JAX's probes cut depth."""
    over = {"num_layers": cfg.dense_layers + cfg.pattern_period}
    if cfg.encoder_layers:
        over["encoder_layers"] = 1
    return over


def hlo_lines(records, n: int) -> str:
    """``records`` as post-SPMD HLO lines over groups of ``n`` ranks."""
    groups = ",".join(map(str, range(n)))
    out = []
    for i, r in enumerate(records):
        t = f"{HLO_DTYPE[str(r.dtype)]}[{','.join(map(str, r.shape))}]"
        out.append(f"  %c.{i} = {t}{{0}} {r.kind}({t}{{0}} %x.{i}), "
                   f"replica_groups={{{{{groups}}}}}, to_apply=%add")
    return "\n".join(out)


def main(path: str) -> None:
    import dataclasses

    import repro.launch.dryrun as JD   # first: sets 512 host devices
    from repro.analysis.roofline import collective_stats as jax_stats
    from repro.launch.mesh import make_production_mesh as jax_mesh
    from repro_torch.analysis.roofline import collective_stats
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch.dryrun import lower_cell, mesh_count, smoke_inputs
    from repro_torch.parallel import comm as C

    rec: dict = {}
    try:
        JD.lower_cell("granite_8b", "decode_32k", False,
                      extra_cfg={"num_layers": 2})
        rec["jax_pod1/error"] = "no error"
    except ValueError as e:
        rec["jax_pod1/error"] = str(e)
    port, _ = lower_cell("granite_8b", "decode_32k", "pod1",
                         extra_cfg={"num_layers": 2}, card=CARD)
    rec["port_pod1"] = json.dumps(port)

    for tag, multi, n in (("pod1", False, 256), ("pod2", True, 512)):
        jm = jax_mesh(multi_pod=multi)
        rec[f"mesh/{tag}/jax"] = repr((tuple(jm.shape.values()),
                                       tuple(jm.axis_names)))
        with M.fake_process_group(n):
            pm = M.make_production_mesh(multi_pod=multi, device="cpu")
            rec[f"mesh/{tag}/port"] = repr((tuple(pm.mesh.shape),
                                            tuple(pm.mesh_dim_names)))

    with M.fake_process_group(8):
        mesh = M.make_host_mesh(*L.STEP_MESH, device="cpu")
        L.count_leg(rec, mesh, device="meta")
        cfg = get_smoke_config("granite_8b")
        model, inputs, _ = smoke_inputs(cfg, "train", "meta", *L.COUNT_SHAPE)
        records = mesh_count(cfg, "train", model, inputs, mesh).collectives
        for n in STATS_GROUPS:
            mine = [dataclasses.replace(r, group_size=n) for r in records]
            rec[f"stats/{n}/port"] = json.dumps(collective_stats(mine))
            rec[f"stats/{n}/jax"] = json.dumps(jax_stats(hlo_lines(records,
                                                                   n)))
        import torch
        from torch.distributed.tensor import DTensor, Replicate, Shard

        x = DTensor.from_local(torch.ones(2, 3, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        try:
            with C.no_functional_collectives():
                x.full_tensor()
            rec["guard/error"] = "no error"
        except RuntimeError as e:
            rec["guard/error"] = str(e)

    for arch, shape in FAKE_CELLS:
        over = {**one_period(get_config(arch)), **PROBE}
        cell, _ = lower_cell(arch, shape, "pod2", extra_cfg=over, card=CARD)
        rec[f"pod2/{arch}/{shape}"] = json.dumps(cell)
    np.savez(path, **{k: np.asarray(v) for k, v in rec.items()})
