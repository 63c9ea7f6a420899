"""The port's sharded trainer over ``torch.distributed`` ranks, for
``tests/test_torch_parallel.py``: what each of 8 gloo CPU ranks runs
(`legs`, spawned by `_torch_ranks.spawn_ranks`), and the single-process
counterparts the test runs itself.  Torch and the port only, never JAX.

On 8 ranks: the sharded train step of each of STEP_ARCHS and
MIXER_ARCHS on a 4 x 2 ("data", "model") mesh (`sharded_step`;
ACCUM_ARCH's also at accum_steps 2), a prefill and SERVE_STEPS decode
steps of each of SERVE_ARCHS on the same mesh, rows and caches split and
(2 rows, a cache of 31) whole (`serve_leg`, SERVE_CASES), the
dry-run's count of COUNT_ARCHS' train and decode steps on it
(`count_leg`, rank 0 records), each step with DTensor's own collectives
forbidden; split-K decode attention on
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
MIXER_ARCHS = ("deepseek_v2_236b", "mamba2_370m", "jamba_1_5_large_398b",
               "whisper_base")              # MLA, SSD, hybrid, enc-dec
SERVE_ARCHS = ("granite_8b", "phi3_5_moe_42b", "deepseek_v2_236b",
               "mamba2_370m", "jamba_1_5_large_398b", "whisper_base",
               "internvl2_2b")
SERVE_B, SERVE_S, SERVE_STEPS, SERVE_LEN = 8, 16, 3, 32
# rows and cache length of each serve case: "serve" splits both on 4 x 2;
# "serve_rep" has 2 rows (no split over 4 "data" ranks) and a cache of 31
# (none over 2 "model" ranks), so `ax.constrain` drops those axes
SERVE_CASES = {"serve": (SERVE_B, SERVE_LEN), "serve_rep": (2, 31)}
COUNT_ARCHS = ("granite_8b", "mamba2_370m")
COUNT_KINDS = ("train", "decode")
COUNT_SHAPE = (8, 16, 32)                         # rows, tokens, cache
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
    """tests/test_parallel.py's batch: rng(0), (8, 32) tokens and labels;
    then an encoder-decoder's frames (8, encoder_seq, d_model)."""
    rng = np.random.default_rng(0)
    out = {k: rng.integers(0, cfg.vocab_size, (STEP_B, STEP_S)).astype(
        np.int32) for k in ("tokens", "labels")}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (STEP_B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


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
    from repro_torch.parallel import comm as C
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
    with logical_rules(mesh), C.no_functional_collectives():
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


def serve_inputs(cfg, b: int = SERVE_B) -> dict:
    """rng(1): the prompt (b, SERVE_S), the SERVE_STEPS decode tokens
    (teacher-forced), a VLM's vision embeddings and an encoder-decoder's
    frames."""
    rng = np.random.default_rng(1)
    v = cfg.vocab_size
    out = {"tokens": rng.integers(0, v, (b, SERVE_S)).astype(np.int32),
           "steps": rng.integers(0, v, (b, SERVE_STEPS)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def serve_run(cfg, model, caches, place, b: int = SERVE_B) -> tuple:
    """A prefill of `serve_inputs` (b rows) into ``caches``, then
    SERVE_STEPS decode steps; ``place`` turns a dict of numpy leaves into
    the step's inputs.  Returns (the prefill's and each step's logits,
    caches)."""
    import torch

    x = serve_inputs(cfg, b)
    batch = place({k: v for k, v in x.items() if k != "steps"})
    if cfg.family == "audio":
        lg, caches = model.prefill(batch["tokens"], batch["frames"], caches)
    elif cfg.family == "vlm":
        lg, caches = model.prefill(batch["tokens"], caches,
                                   vision_embeds=batch["vision_embeds"])
    else:
        lg, caches = model.prefill(batch["tokens"], caches)
    out = [lg]
    s0 = SERVE_S + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    for k in range(SERVE_STEPS):
        tok = place({"token": x["steps"][:, k:k + 1]})["token"]
        lg, caches = model.decode_step(
            tok, caches, torch.full((b,), s0 + k, dtype=torch.int32))
        out.append(lg)
    return out, caches


def cache_leaves(caches) -> dict:
    """{name: leaf} of a model's caches (a list of per-layer dicts, or the
    encoder-decoder's dict)."""
    if isinstance(caches, dict):
        return dict(caches)
    return {f"{i}/{k}": v for i, c in enumerate(caches)
            for k, v in c.items()}


def single_serve(arch: str, case: str = "serve") -> tuple:
    """`serve_run` of SERVE_CASES[case] in this one process: (logits,
    {cache leaf: array})."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import api

    cfg = get_smoke_config(arch)
    m = api(cfg)
    model = m.init_params(device="cpu", seed=0)
    b, length = SERVE_CASES[case]
    caches = m.init_caches(b, length, device="cpu")
    out, caches = serve_run(cfg, model, caches, lambda d: {
        k: torch.as_tensor(v) for k, v in d.items()}, b)
    return ([o.numpy() for o in out],
            {k: v.numpy() for k, v in cache_leaves(caches).items()})


def save_block(rec: dict, key: str, t) -> None:
    """This rank's block of the DTensor ``t`` under ``key`` and its slices
    of the whole under ``key@idx`` ((start, stop) a dimension)."""
    from repro_torch.parallel.ax import block_index, mesh_shape
    from repro_torch.parallel.shardings import local

    mesh = t.device_mesh
    idx = block_index(t.shape, mesh_shape(mesh), t.placements,
                      mesh.get_coordinate())
    rec[key] = local(t).detach().numpy().copy()
    rec[f"{key}@idx"] = np.asarray([[s.start, s.stop] for s in idx])


def serve_leg(rec: dict, arch: str, mesh, case: str = "serve") -> None:
    """`serve_run` of SERVE_CASES[case] with the parameters placed by
    ``param_specs``, the inputs by ``batch_spec``, the caches by
    ``cache_specs`` on ``mesh``, under ``logical_rules``: this rank's
    blocks of each logits and of every cache leaf after the last step,
    under ``case/arch``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import api
    from repro_torch.parallel import comm as C
    from repro_torch.parallel import shardings as SH
    from repro_torch.parallel.ax import logical_rules

    cfg = get_smoke_config(arch)
    m = api(cfg)
    model = m.init_params(device="cpu", seed=0)
    SH.shard_params(model, SH.to_named(SH.param_specs(model), mesh))
    b, length = SERVE_CASES[case]
    caches = m.init_caches(b, length, device="cpu")
    caches = SH.shard_state(caches, SH.to_named(SH.cache_specs(caches, mesh),
                                                mesh))
    with logical_rules(mesh), C.no_functional_collectives():
        out, caches = serve_run(cfg, model, caches,
                                lambda d: SH.shard_batch(d, mesh, "cpu"), b)
    for j, lg in enumerate(out):
        save_block(rec, f"{case}/{arch}/logits{j}", lg)
    for k, v in cache_leaves(caches).items():
        save_block(rec, f"{case}/{arch}/cache/{k}", v)


def count_leg(rec: dict, mesh, device: str = "cpu") -> None:
    """The dry-run's count (`launch.dryrun.mesh_count`) of COUNT_ARCHS'
    COUNT_KINDS steps at COUNT_SHAPE on ``mesh`` (blocks on ``device``):
    FLOPs, bytes and each collective's kind, bytes and group size, under
    ``count/arch/kind``.  The ranks run it on the CPU; the fake group's
    meta count in a subprocess runs it too."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.dryrun import mesh_count, smoke_inputs

    for arch in COUNT_ARCHS:
        cfg = get_smoke_config(arch)
        for kind in COUNT_KINDS:
            model, inputs, _ = smoke_inputs(cfg, kind, device, *COUNT_SHAPE)
            c = mesh_count(cfg, kind, model, inputs, mesh, live=False)
            pre = f"count/{arch}/{kind}"
            rec[f"{pre}/flops"] = np.asarray(c.flops)
            rec[f"{pre}/bytes"] = np.asarray(c.bytes)
            rec[f"{pre}/kinds"] = np.asarray([r.kind for r in c.collectives])
            rec[f"{pre}/nbytes"] = np.asarray(
                [r.nbytes for r in c.collectives], dtype=np.int64)
            rec[f"{pre}/groups"] = np.asarray(
                [r.group_size for r in c.collectives], dtype=np.int64)


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
    for arch in STEP_ARCHS + MIXER_ARCHS:
        sharded_step(rec, arch, mesh)
    sharded_step(rec, ACCUM_ARCH, mesh, accum=2)
    rec["rank/step_seconds"] = np.asarray(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for case in SERVE_CASES:
        for arch in SERVE_ARCHS:
            serve_leg(rec, arch, mesh, case)
    rec["rank/serve_seconds"] = np.asarray(time.perf_counter() - t0)
    t0 = time.perf_counter()
    cnt: dict = {}
    count_leg(cnt, mesh)
    if rank == 0:
        rec.update(cnt)
    rec["rank/count_seconds"] = np.asarray(time.perf_counter() - t0)
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
