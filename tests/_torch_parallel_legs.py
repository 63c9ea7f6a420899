"""The port's sharded trainer over ``torch.distributed`` ranks, for
``tests/test_torch_parallel.py``: what each of 8 gloo CPU ranks runs
(`legs`, spawned by `_torch_ranks.spawn_ranks`), and the single-process
counterparts the test runs itself.  Torch and the port only, never JAX.

On 8 ranks: the sharded train step of each of STEP_ARCHS on a 4 x 2
("data", "model") mesh (`sharded_step`; ACCUM_ARCH's also at
accum_steps 2), split-K decode attention on
1 x 8, ``compressed_pmean`` on 8 x 1, a 4 x 2 save restored onto 2 x 1
(ranks 0-1); then ranks 0-3 alone start a group of 4 and run the CLI on
2 x 2: 8 steps through, and 4 steps with a checkpoint resumed to 8.
Every rank records its blocks; the test cuts the single process's whole
tensors by each rank's placements (`block`) and compares.
"""

from __future__ import annotations

import time

import numpy as np

STEP_ARCHS = ("granite_8b", "phi3_5_moe_42b")
STEP_MESH = (4, 2)
STEP_OPT = dict(lr=1e-3, state_dtype="float32")   # tests/test_parallel.py
STEP_B, STEP_S = 8, 32
ACCUM_ARCH = "granite_8b"                           # also at accum_steps 2
SPLITK = dict(B=4, H=8, KVH=2, D=32, S=64)          # test_parallel.py:55-74
SPLITK_LENS = (5, 17, 64, 33)
PMEAN = (8, 64)                                     # test_parallel.py's x
RESTORE_FROM, RESTORE_TO = (4, 2), (2, 1)
CLI_MESH = (2, 2)
CLI = ["--arch", "granite_8b", "--smoke", "--device", "cpu", "--batch", "8",
       "--seq", "32", "--data", str(CLI_MESH[0]), "--model", str(CLI_MESH[1])]
CLI_KILL, CLI_STEPS = 4, 8


def step_batch(cfg) -> dict:
    """tests/test_parallel.py's batch: rng(0), (8, 32) tokens and labels."""
    rng = np.random.default_rng(0)
    return {k: rng.integers(0, cfg.vocab_size, (STEP_B, STEP_S)).astype(
        np.int32) for k in ("tokens", "labels")}


def single_step(arch: str, accum: int = 1):
    """(model after one step, optimizer state, metrics, the parameters
    before it) in this one process: seed-0 smoke weights, `step_batch`,
    AdamW(STEP_OPT)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import api
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    cfg = get_smoke_config(arch)
    ocfg = AdamWConfig(**STEP_OPT)
    model = api(cfg).init_params(device="cpu", seed=0)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = adamw_init(ocfg, dict(model.named_parameters()))
    batch = {k: torch.as_tensor(v) for k, v in step_batch(cfg).items()}
    model, opt, met = make_train_step(cfg, ocfg, accum)(model, opt, batch)
    return model, opt, met, before


def sharded_step(rec: dict, arch: str, mesh, accum: int = 1) -> None:
    """The same step with the parameters placed by ``param_specs`` on
    ``mesh``, the batch by ``batch_spec``, under ``logical_rules``: this
    rank's blocks before (``init/``) and after (``step/``) the step, of
    the first moment after it (``m/``: the clipped gradient times
    1 - b1) and the metrics, under ``arch`` (``arch/a2`` at ``accum``
    2)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import api
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import shardings as SH
    from repro_torch.parallel.ax import logical_rules
    from repro_torch.train import make_train_step

    cfg = get_smoke_config(arch)
    ocfg = AdamWConfig(**STEP_OPT)
    pre = arch if accum == 1 else f"{arch}/a{accum}"
    model = api(cfg).init_params(device="cpu", seed=0)
    SH.shard_params(model, SH.to_named(SH.param_specs(model), mesh))
    named = dict(model.named_parameters())
    for k, p in named.items():
        rec[f"{pre}/init/{k}"] = SH.local(p).detach().numpy().copy()
    opt = adamw_init(ocfg, named)
    batch = SH.shard_batch({k: torch.as_tensor(v) for k, v in
                            step_batch(cfg).items()}, mesh, "cpu")
    with logical_rules(mesh):
        model, opt, met = make_train_step(cfg, ocfg, accum)(model, opt,
                                                             batch)
    for k, p in model.named_parameters():
        rec[f"{pre}/step/{k}"] = SH.local(p).detach().numpy().copy()
        rec[f"{pre}/m/{k}"] = SH.local(opt["m"][k]).numpy().copy()
    for k in ("loss", "grad_norm", "lr"):
        rec[f"{pre}/{k}"] = np.asarray(float(met[k]))
    rec[f"{pre}/bytes"] = np.asarray(SH.local_bytes(named)
                                      + SH.local_bytes(opt["m"])
                                      + SH.local_bytes(opt["v"]))


def splitk_inputs():
    """test_parallel.py:55-74's inputs, as torch tensors."""
    import torch

    s = SPLITK
    rng = np.random.default_rng(0)
    q = rng.standard_normal((s["B"], 1, s["H"], s["D"]))
    k = rng.standard_normal((s["B"], s["S"], s["KVH"], s["D"]))
    v = rng.standard_normal((s["B"], s["S"], s["KVH"], s["D"]))
    return (torch.as_tensor(q, dtype=torch.float32),
            torch.as_tensor(k, dtype=torch.float32),
            torch.as_tensor(v, dtype=torch.float32),
            torch.as_tensor(SPLITK_LENS, dtype=torch.int32))


def pmean_input() -> np.ndarray:
    return np.random.default_rng(0).standard_normal(PMEAN).astype(np.float32)


def restore_leg(rec: dict, out_dir: str) -> None:
    """Granite's seed-0 smoke parameters placed on RESTORE_FROM and saved;
    ranks 0-1 restore them onto RESTORE_TO: their blocks and each leaf's
    mesh size."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import api
    from repro_torch.parallel import shardings as SH

    cfg = get_smoke_config("granite_8b")
    model = api(cfg).init_params(device="cpu", seed=0)
    specs = SH.param_specs(model)
    SH.shard_params(model, SH.to_named(specs, make_host_mesh(
        *RESTORE_FROM, device="cpu")))
    ck = CheckpointManager(f"{out_dir}/ckpt", async_save=False)
    ck.save(1, dict(model.named_parameters()))
    mesh_b = make_host_mesh(*RESTORE_TO, device="cpu")
    if mesh_b.get_coordinate() is not None:
        _, got, _ = ck.restore(None, {k: None for k in specs},
                               shardings=SH.to_named(specs, mesh_b))
        for k, t in got.items():
            rec[f"restore/{k}"] = SH.local(t).numpy().copy()
            rec[f"restore_mesh/{k}"] = np.asarray(t.device_mesh.size())
    dist.barrier()


def cli_leg(rec: dict, out_dir: str) -> None:
    """The CLI on CLI_MESH: 8 steps through, then 4 with a checkpoint and
    ``--resume`` to 8; each run's final blocks."""
    from repro_torch.launch import train as TR
    from repro_torch.parallel.shardings import local

    ck = ["--ckpt-dir", f"{out_dir}/cli_ckpt", "--ckpt-every", "100"]
    runs = {"through": TR.main(CLI + ["--steps", str(CLI_STEPS)])}
    TR.main(CLI + ["--steps", str(CLI_KILL)] + ck)
    runs["resumed"] = TR.main(CLI + ["--steps", str(CLI_STEPS), "--resume"]
                              + ck)
    for tag, model in runs.items():
        for k, p in model.named_parameters():
            rec[f"cli/{tag}/{k}"] = local(p).detach().numpy().copy()


def legs(world: int, out_dir: str) -> dict:
    """Everything a rank runs (the module's docstring); the record."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh, start_process_group
    from repro_torch.optim import compressed_pmean, quantize_int8
    from repro_torch.parallel.decode_attn import split_k_decode_attention

    rank = dist.get_rank()
    rec: dict = {}
    t0 = time.perf_counter()
    mesh = make_host_mesh(*STEP_MESH, device="cpu")
    for arch in STEP_ARCHS:
        sharded_step(rec, arch, mesh)
    sharded_step(rec, ACCUM_ARCH, mesh, accum=2)
    rec["rank/step_seconds"] = np.asarray(time.perf_counter() - t0)
    q, k, v, lens = splitk_inputs()
    rec["splitk"] = split_k_decode_attention(
        make_host_mesh(1, world, device="cpu"), q, k, v, lens).numpy()
    import torch

    row = torch.as_tensor(pmean_input()[rank:rank + 1])
    rec["pmean_q"] = quantize_int8(row)[0].numpy()
    rec["pmean"] = compressed_pmean(
        {"x": row}, make_host_mesh(world, 1, device="cpu"),
        "data")["x"].numpy()
    restore_leg(rec, out_dir)
    dist.destroy_process_group()
    if rank < CLI_MESH[0] * CLI_MESH[1]:
        start_process_group("gloo", rank=rank,
                            world_size=CLI_MESH[0] * CLI_MESH[1],
                            init_method=f"file://{out_dir}/store_cli")
        t0 = time.perf_counter()
        cli_leg(rec, out_dir)
        rec["rank/cli_seconds"] = np.asarray(time.perf_counter() - t0)
        dist.destroy_process_group()
    return rec
