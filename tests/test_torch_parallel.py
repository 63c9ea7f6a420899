"""PyTorch port: the distribution layer (``repro_torch.parallel``) and the
sharded trainer over ``torch.distributed`` gloo CPU ranks, against the
JAX package's ``repro.parallel`` and against the port's own single
process.

- Specs: ``param_specs`` / ``opt_specs`` equal JAX's for every smoke
  config (JAX's side from ``jax.eval_shape``: no compute, no devices),
  names mapped through ``weights.jax_state_dict``, the scan-stacked
  leaves' leading None dropped; ``cache_specs`` and ``batch_spec`` equal
  JAX's on ``AbstractMesh`` (4, 2) and (2, 16, 16).
- On 8 ranks, spawned once per test run (`_torch_parallel_legs`):
  the sharded step of Granite and Phi-3.5-MoE smoke on a 4 x 2 mesh
  (Granite also at accum_steps 2) equals the single process's (loss
  within 1e-4, every leaf within 5e-3: tests/test_parallel.py's
  bounds; each rank's first moment, the clipped gradient, within 1e-3
  of the leaf's largest), and each rank's blocks are the
  slices of the whole leaves its placements name; split-K on 1 x 8
  within 1e-5 of JAX's ``decode_attention``; ``compressed_pmean`` on
  8 x 1 (int8 payloads JAX's bit for bit, the mean within 1e-6 of the
  mean of JAX's dequantized rows and within 0.05 of the exact one); a
  4 x 2 save restored onto 2 x 1 and onto one process, bit for bit; the
  CLI on 2 x 2 killed at step 4 and resumed to 8 equals 8 steps through,
  bit for bit.  The single process is held to JAX's unsharded
  ``jax.jit(step)`` as tests/test_torch_train.py holds it.
- The reference's fault: JAX's step under a 1 x 1 mesh with
  ``logical_rules`` raises; the port's 1 x 1 mesh path runs and equals
  its unsharded step bit for bit.
- The other mixers and serving over the mesh (on the same 8 ranks): the
  sharded step of DeepSeek-V2 (MLA), Mamba2 (SSD), Jamba (hybrid) and
  Whisper (encoder-decoder) smoke held as above; a prefill of 8 x 16
  tokens and 3 decode steps of seven families over caches placed by
  ``cache_specs``, logits and each rank's cache blocks within 1e-5
  (of the largest |value|, at least 1) of the single process's; every
  sharded step under ``no_functional_collectives`` (no collective of
  DTensor's own).
- The dry-run (one subprocess, `_torch_fake_legs`, which the first xdist
  worker to import this module starts, so that it runs beside the other
  tests and the spawn):
  the fake group's meta count at 4 x 2 of Granite's and Mamba2's train
  and decode steps equals rank 0's real count exactly (FLOPs, bytes,
  collectives); ``collective_stats`` of the port's records equals JAX's
  of the same collectives rendered as HLO at group sizes 2, 16 and 32;
  ``make_production_mesh`` equals ``jax.make_mesh``'s meshes; one pod2
  cell per family and step kind gives a JAX-schema record; JAX's own
  pod1 dry-run raises (the reference's fault) where the port's gives a
  record.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_parallel_legs as L
import _torch_ranks as TR
from _torch_fake_legs import FAKE_CELLS
from _torch_parity import (
    TRAIN_B,
    TRAIN_OPT,
    few_jax_executables,  # noqa: F401  (autouse)
    jax_train_leg,
    prefixed,
    shared_npz,
    train_data,
)
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models.registry import api, model_class
from repro_torch.models.weights import jax_state_dict
from repro_torch.parallel import shardings as SH
from repro_torch.parallel.ax import block_index, placements_for

WORLD = 8
LOSS_TOL, LEAF_TOL = 1e-4, 5e-3        # tests/test_parallel.py's bounds
GRAD_RTOL = 1e-3                        # of a leaf's largest |m|
SPLITK_TOL = 1e-5
SERVE_TOL = 1e-5                        # logits and cache blocks
REP_TOL = 3.3e-6                        # the same with rows and caches whole
PMEAN_JAX_TOL, PMEAN_EXACT_TOL = 1e-6, 0.05
METRIC_TOL = 1e-5                       # tests/test_torch_train.py's
CACHE_MESHES = {"4x2": {"data": 4, "model": 2},
                "pod2": {"pod": 2, "data": 16, "model": 16}}
CACHE_SHAPES = ((8, 64), (64, 128), (3, 10))
HOST_AXES = types.SimpleNamespace(mesh_dim_names=("data", "model"))
TESTS = str(Path(__file__).resolve().parent)
SRC = str(Path(TESTS).parent / "src")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start_fake_legs(d: Path) -> None:
    """`_torch_fake_legs.main` in a subprocess of its own (the environment
    `_subproc.run_py` gives one), started, not waited for: it leaves
    ``d/fake.npz`` when it ends well, ``d/failed`` when not, its output in
    ``d/out.txt``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    part, done, failed = d / "fake.part.npz", d / "fake.npz", d / "failed"
    code = (f"import os, sys; sys.path.insert(0, {TESTS!r})\n"
            f"import _torch_fake_legs as F\n"
            f"try:\n    F.main({str(part)!r})\n"
            f"    os.replace({str(part)!r}, {str(done)!r})\n"
            f"except BaseException:\n"
            f"    open({str(failed)!r}, 'w').close()\n    raise\n")
    with open(d / "out.txt", "w") as out:
        subprocess.Popen([sys.executable, "-c", code], env=env, stdout=out,
                         stderr=subprocess.STDOUT)


def _fake_dir() -> Path | None:
    """The fake-group subprocess's directory of this xdist run (None
    outside xdist)."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    return (None if uid is None else
            Path(tempfile.gettempdir()) / f"torch_parallel_fake_{uid}")


def _prestart_fake_legs() -> None:
    """The first xdist worker to import this module starts the
    fake-group subprocess, so that it runs while the workers run other
    tests (its file ``started`` claims it)."""
    d = _fake_dir()
    if d is None:
        return
    d.mkdir(parents=True, exist_ok=True)
    try:
        os.close(os.open(d / "started", os.O_CREAT | os.O_EXCL))
    except FileExistsError:
        return
    _start_fake_legs(d)


_prestart_fake_legs()


def _wait_fake_legs(d: Path, timeout: float = 600) -> dict:
    deadline = time.monotonic() + timeout
    while not (d / "fake.npz").exists():
        assert not (d / "failed").exists(), (d / "out.txt").read_text()
        assert time.monotonic() < deadline, "the fake-group legs timed out"
        time.sleep(0.5)
    with np.load(d / "fake.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """Each rank's record of `_torch_parallel_legs.legs` (8 ranks) under
    its rank, and under ``fake/`` `_torch_fake_legs`' record (every count
    on a fake process group, in one subprocess: started at import by the
    first xdist worker, else here beside the ranks): once per test run,
    shared by the xdist workers."""
    def make(path):
        t0 = time.perf_counter()
        d = _fake_dir()
        if d is None or not (d / "started").exists():
            d = Path(f"{path}.fake")
            d.mkdir(parents=True, exist_ok=True)
            _start_fake_legs(d)
        recs = TR.spawn_ranks(WORLD, Path(f"{path}.d"), legs=L.legs)
        out = {f"{r}/{k}": v for r, rec in enumerate(recs)
               for k, v in rec.items()}
        out.update({f"fake/{k}": v
                    for k, v in _wait_fake_legs(d).items()})
        shutil.rmtree(d, ignore_errors=True)
        out["wall_seconds"] = np.asarray(time.perf_counter() - t0)
        tmp = f"{path}.part.npz"
        np.savez(tmp, **out)
        Path(tmp).replace(path)

    return shared_npz(tmp_path_factory, "torch_parallel_ranks", make)


@pytest.fixture(scope="module")
def ranks(shared):
    return [prefixed(shared, str(r)) for r in range(WORLD)]


@pytest.fixture(scope="module")
def fake(shared):
    return prefixed(shared, "fake")


def block(full: np.ndarray, spec, mesh_shape: tuple, coord: tuple):
    """The block of ``full`` the rank at ``coord`` of a ("data", "model")
    mesh of ``mesh_shape`` holds under ``spec``."""
    pl = placements_for(spec, HOST_AXES)
    return full[block_index(full.shape, mesh_shape, pl, coord)]


# ------------------------------------------------------------- the specs ---


def _jax_specs_by_name(jcfg, tree):
    """JAX's params-shaped tree of specs as {port name: spec tuple}: the
    scan-stacked subtrees' leaves lose their leading (stack) entry."""
    n = max(jcfg.num_layers, jcfg.encoder_layers or 0)

    def stacked(node):
        if isinstance(node, dict):
            return {k: stacked(v) for k, v in node.items()}
        spec = tuple(node)
        assert not spec or spec[0] is None, spec
        arr = np.empty(n, dtype=object)
        arr[:] = [spec[1:]] * n
        return arr

    def flat(node):
        if isinstance(node, dict):
            return {k: flat(v) for k, v in node.items()}
        return tuple(node)

    out = {k: flat(v) for k, v in tree.items()
           if k not in ("slots", "prologue", "encoder", "decoder")}
    if jcfg.family == "audio":
        out["encoder"] = stacked(tree["encoder"])
        out["decoder"] = stacked(tree["decoder"])
    else:
        out["prologue"] = [flat(p) for p in tree["prologue"]]
        out["slots"] = [stacked(s) for s in tree["slots"]]
    pcfg = get_smoke_config(_arch_of(jcfg))
    return {k: tuple(v) for k, v in jax_state_dict(pcfg, out).items()}


_ARCH_BY_NAME = {get_smoke_config(a).name: a for a in ARCH_IDS}


def _arch_of(cfg) -> str:
    return _ARCH_BY_NAME[cfg.name]


def _port_named(arch: str) -> dict:
    cfg = get_smoke_config(arch)
    return dict(model_class(cfg)(cfg, device="meta",
                                 init=False).named_parameters())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_equal_jax(arch):
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.registry import api as jax_api
    from repro.parallel import shardings as JSH

    jcfg = jax_smoke(arch)
    shapes = jax.eval_shape(jax_api(jcfg).init_params, jax.random.key(0))
    jspecs = JSH.param_specs(shapes)
    want = _jax_specs_by_name(jcfg, jspecs)
    named = _port_named(arch)
    got = {k: tuple(v) for k, v in SH.param_specs(named).items()}
    assert got == want
    jopt, popt = JSH.opt_specs(jspecs), SH.opt_specs(SH.param_specs(named))
    assert set(jopt) == set(popt) == {"m", "v", "step"}
    for k in ("m", "v"):
        assert {n: tuple(s) for n, s in popt[k].items()} == \
            _jax_specs_by_name(jcfg, jopt[k])
    assert tuple(popt["step"]) == tuple(jopt["step"]) == ()


def _jax_cache_specs_by_layer(jcfg, jspecs) -> list | dict:
    """JAX's cache spec tree in the port's layout: per layer for a
    decoder (a slot's stacked specs lose their leading entry), as is for
    the encoder-decoder's L-stacked dict."""
    if jcfg.family == "audio":
        return {k: tuple(v) for k, v in jspecs.items()}
    from repro_torch.models.transformer import _layout

    n_pro, period, reps = _layout(get_smoke_config(_arch_of(jcfg)))
    out = [{k: tuple(v) for k, v in c.items()} for c in jspecs["prologue"]]
    for i in range(n_pro, jcfg.num_layers):
        j = (i - n_pro) % period
        out.append({k: tuple(v)[1:] for k, v in jspecs["slots"][j].items()})
    return out


def _plain(specs):
    if isinstance(specs, dict):
        return {k: tuple(v) for k, v in specs.items()}
    return [_plain(s) for s in specs]


@pytest.mark.parametrize("mesh", sorted(CACHE_MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_jax(arch, mesh):
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.registry import api as jax_api
    from repro.parallel import shardings as JSH

    sizes = CACHE_MESHES[mesh]
    amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    jcfg, pcfg = jax_smoke(arch), get_smoke_config(arch)
    for b, s in CACHE_SHAPES:
        jc = jax.eval_shape(lambda b=b, s=s: jax_api(jcfg).init_caches(b, s))
        want = _jax_cache_specs_by_layer(jcfg, JSH.cache_specs(jc, amesh))
        pc = api(pcfg).init_caches(b, s, device="meta")
        assert _plain(SH.cache_specs(pc, sizes)) == want, (b, s)
        for nd in (1, 2, 3):
            assert tuple(SH.batch_spec(sizes, b, nd)) == \
                tuple(JSH.batch_spec(amesh, b, nd)), (b, nd)
            assert SH.batch_axes(sizes, b) == JSH.batch_axes(amesh, b)


# ------------------------------------------------------ the sharded step ---


@pytest.mark.parametrize("arch", L.STEP_ARCHS)
def test_rank_blocks_are_the_slices_their_placements_name(ranks, arch):
    *_, before = L.single_step(arch)
    specs = SH.param_specs(before)
    for r, rec in enumerate(ranks):
        coord = divmod(r, L.STEP_MESH[1])
        for k, full in before.items():
            want = block(full.numpy(), specs[k], L.STEP_MESH, coord)
            np.testing.assert_array_equal(rec[f"{arch}/init/{k}"], want,
                                          err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("arch, accum", [(a, 1) for a in L.STEP_ARCHS
                                          + L.MIXER_ARCHS]
                         + [(L.ACCUM_ARCH, 2)])
def test_sharded_step_matches_single_process(ranks, arch, accum):
    """Loss and gradient norm within 1e-4, every leaf within 5e-3 (JAX's
    bounds), and each rank's first moment after the step (the clipped
    gradient times 1 - b1) within 1e-3 of the leaf's largest of the
    single process's block: the step's update is about lr / 100 a
    parameter (the warm-up's first step), so only the gradient tells a
    wrong one apart.  MIXER_ARCHS are the other mixers: MLA, the SSD,
    the hybrid and the encoder-decoder."""
    model, opt, met, _ = L.single_step(arch, accum)
    pre = arch if accum == 1 else f"{arch}/a{accum}"
    specs = SH.param_specs(model)
    full = {k: p.detach().numpy() for k, p in model.named_parameters()}
    moment = {k: m.numpy() for k, m in opt["m"].items()}
    whole = sum(p.nbytes for p in full.values()) * 3
    for r, rec in enumerate(ranks):
        assert abs(float(rec[f"{pre}/loss"]) - float(met["loss"])) \
            < LOSS_TOL, r
        assert abs(float(rec[f"{pre}/grad_norm"])
                   - float(met["grad_norm"])) < LOSS_TOL, r
        coord = divmod(r, L.STEP_MESH[1])
        worst = max(float(np.abs(rec[f"{pre}/step/{k}"] - block(
            v, specs[k], L.STEP_MESH, coord)).max()) for k, v in full.items())
        assert worst < LEAF_TOL, (r, worst)
        for k, m in moment.items():
            err = np.abs(rec[f"{pre}/m/{k}"]
                         - block(m, specs[k], L.STEP_MESH, coord)).max()
            assert err <= GRAD_RTOL * np.abs(m).max(), (r, k, err)
        # the storage is sharded: about 1/8 of the parameters and moments
        assert int(rec[f"{pre}/bytes"]) < whole / 4, r


@pytest.mark.parametrize("arch", L.STEP_ARCHS)
def test_single_process_step_matches_jax(tmp_path_factory, arch):
    """The sharded step's oracle, held to JAX's unsharded ``jax.jit(step)``
    (tests/test_torch_train.py's first leg and bounds)."""
    from repro_torch.data import DataConfig, batch_at_step, to_device
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    j = jax_train_leg(tmp_path_factory, arch)
    cfg = get_smoke_config(arch)
    ocfg = AdamWConfig(**TRAIN_OPT)
    model = api(cfg).init_params(device="cpu", seed=0)
    opt = adamw_init(ocfg, dict(model.named_parameters()))
    batch = to_device(batch_at_step(DataConfig(**train_data(
        cfg, TRAIN_B)), 0), "cpu")
    model, opt, met = make_train_step(cfg, ocfg)(model, opt, batch)
    for k in ("loss", "grad_norm", "lr"):
        want = float(j[f"a1/{k}"][0])
        assert abs(float(met[k]) - want) <= METRIC_TOL * abs(want), k
    lr = float(j["a1/lr"][0])
    for k, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - j[f"a1/s0/param/{k}"]).max()
        assert d <= 2 * lr, (k, d)


# ---------------------------------------- split-K, compressed mean, restore ---


def test_split_k_matches_jax_decode_attention(ranks):
    import jax.numpy as jnp

    from repro.models.layers.attention import decode_attention

    q, k, v, lens = L.splitk_inputs()
    want = np.asarray(decode_attention(jnp.asarray(q.numpy()),
                                       jnp.asarray(k.numpy()),
                                       jnp.asarray(v.numpy()),
                                       jnp.asarray(lens.numpy())))
    for r, rec in enumerate(ranks):
        assert rec["splitk"].shape == want.shape
        assert float(np.abs(rec["splitk"] - want).max()) < SPLITK_TOL, r


def test_compressed_pmean_matches_jax_quantization(ranks):
    import jax.numpy as jnp

    from repro.optim.compress import dequantize_int8, quantize_int8

    x = L.pmean_input()
    deq = []
    for r, rec in enumerate(ranks):
        q, s = quantize_int8(jnp.asarray(x[r:r + 1]))
        np.testing.assert_array_equal(rec["pmean_q"], np.asarray(q))
        deq.append(np.asarray(dequantize_int8(q, s)))
    mean_deq = np.mean(np.stack(deq), axis=0)
    exact = x.mean(axis=0, keepdims=True)
    for r, rec in enumerate(ranks):
        assert float(np.abs(rec["pmean"] - mean_deq).max()) < PMEAN_JAX_TOL
        assert float(np.abs(rec["pmean"] - exact).max()) < PMEAN_EXACT_TOL
        np.testing.assert_array_equal(rec["pmean"], ranks[0]["pmean"])


def test_resharding_restore_bit_exact(ranks, tmp_path_factory):
    """Saved on 4 x 2, restored onto 2 x 1 (ranks 0-1: each block the
    slice of the whole leaf, each leaf on the 2-rank mesh) and onto one
    process (the files are the single process's)."""
    from repro_torch.checkpoint import CheckpointManager

    *_, before = L.single_step("granite_8b")
    specs = SH.param_specs(before)
    root = Path(tmp_path_factory.getbasetemp())
    ckpt = next(p for base in (root, root.parent)
                for p in base.glob("torch_parallel_ranks.npz.d/ckpt"))
    _, got, _ = CheckpointManager(ckpt).restore(None, before, device="cpu")
    for k, t in before.items():
        assert torch.equal(got[k], t), k
    for r in range(2):
        for k, t in before.items():
            np.testing.assert_array_equal(
                ranks[r][f"restore/{k}"],
                block(t.numpy(), specs[k], L.RESTORE_TO, (r, 0)))
            assert int(ranks[r][f"restore_mesh/{k}"]) == 2
    assert not any(k.startswith("restore") for r in ranks[2:] for k in r)


def test_cli_kill_and_resume_on_a_mesh_bit_exact(ranks):
    n = L.CLI_MESH[0] * L.CLI_MESH[1]
    for r, rec in enumerate(ranks[:n]):
        through = prefixed(rec, "cli/through")
        resumed = prefixed(rec, "cli/resumed")
        assert through and set(through) == set(resumed)
        for k in through:
            np.testing.assert_array_equal(through[k], resumed[k],
                                          err_msg=f"rank {r} {k}")
    assert not any(k.startswith("cli/") for r in ranks[n:] for k in r)


# ------------------------------------------------------- the 1 x 1 mesh ---


def test_jax_step_under_a_one_device_mesh_raises():
    """The reference's fault (ROADMAP Queue 3): ``constrain`` hands
    ``with_sharding_constraint`` a spec on the mesh's explicit axes."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch.mesh import make_host_mesh
    from repro.models.registry import api as jax_api
    from repro.optim import AdamWConfig, adamw_init
    from repro.parallel.ax import logical_rules
    from repro.train import make_train_step

    cfg = jax_smoke("granite_8b")
    ocfg = AdamWConfig(**L.STEP_OPT)
    params = jax_api(cfg).init_params(jax.random.PRNGKey(0))
    opt = adamw_init(ocfg, params)
    batch = {k: jnp.asarray(v) for k, v in L.step_batch(cfg).items()}
    mesh = make_host_mesh(1, 1)
    with pytest.raises(ValueError, match="Auto axes"):
        with mesh, logical_rules(mesh):
            jax.jit(make_train_step(cfg, ocfg))(params, opt, batch)


@pytest.mark.parametrize("arch", L.STEP_ARCHS)
def test_one_by_one_mesh_equals_unsharded_step_bit_for_bit(arch):
    """The moments placed by ``shard_state`` (``device_put``'s
    counterpart), the parameters by ``shard_params``."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel.ax import logical_rules
    from repro_torch.train import make_train_step

    want, _, met, _ = L.single_step(arch)
    cfg = get_smoke_config(arch)
    ocfg = AdamWConfig(**L.STEP_OPT)
    mesh = make_host_mesh(1, 1, device="cpu")
    model = api(cfg).init_params(device="cpu", seed=0)
    specs = SH.param_specs(model)
    opt = SH.shard_state(adamw_init(ocfg, dict(model.named_parameters())),
                         SH.to_named(SH.opt_specs(specs), mesh))
    SH.shard_params(model, SH.to_named(specs, mesh))
    batch = SH.shard_batch({k: torch.as_tensor(v) for k, v in
                            L.step_batch(cfg).items()}, mesh)
    with logical_rules(mesh):
        model, opt, got = make_train_step(cfg, ocfg)(model, opt, batch)
    for k in ("loss", "grad_norm", "lr"):
        assert torch.equal(got[k], met[k]), k
    wp = dict(want.named_parameters())
    for k, p in model.named_parameters():
        assert torch.equal(SH.local(p), wp[k].detach()), k


def test_parallel_exports_are_jax_s():
    import repro.parallel as J

    import repro_torch.parallel as T

    assert T.__all__ == J.__all__
    for name in T.__all__:
        assert getattr(T, name) is not None, name


# ------------------------------------------- sharded prefill and decode ---


def _block_of(rec: dict, key: str, full: np.ndarray) -> np.ndarray:
    return full[tuple(slice(a, b) for a, b in rec[f"{key}@idx"])]


@pytest.mark.parametrize("arch", L.SERVE_ARCHS)
def test_sharded_prefill_and_decode_match_single_process(ranks, arch):
    """A prefill of 8 x 16 tokens, then 3 decode steps, on 4 x 2 with the
    caches placed by ``cache_specs``: each rank's block of every logits
    (the prefill's last position and each step's) and of every cache
    leaf after the last step within 1e-5 of the largest |value| of the
    single process's (at least 1: an SSD state grows along the prompt)
    of the slice its placement names (the attention and latent caches
    sharded along their length, the SSD state by head)."""
    logits, caches = L.single_serve(arch)
    pre = f"serve/{arch}"
    for r, rec in enumerate(ranks):
        for j, want in enumerate(logits):
            got = rec[f"{pre}/logits{j}"]
            err = float(np.abs(got - _block_of(rec, f"{pre}/logits{j}",
                                               want)).max())
            assert err < SERVE_TOL * max(1.0, float(np.abs(want).max())), \
                (r, j, err)
        for k, want in caches.items():
            key = f"{pre}/cache/{k}"
            blk = _block_of(rec, key, want)
            assert rec[key].shape == blk.shape, (r, k)
            err = float(np.abs(rec[key] - blk).max())
            assert err < SERVE_TOL * max(1.0, float(np.abs(want).max())), \
                (r, k, err)
    # the length-sharded caches: each rank's block is half the positions
    sharded = [k for k in caches if k.rsplit("/", 1)[-1] in ("k", "ckv")]
    for k in sharded:
        idx = ranks[0][f"{pre}/cache/{k}@idx"]
        axis = 2 if arch == "whisper_base" else 1
        assert idx[axis][1] - idx[axis][0] == L.SERVE_LEN // 2, k


@pytest.mark.parametrize("arch", L.SERVE_ARCHS)
def test_replicated_rows_prefill_and_decode_match_single_process(ranks, arch):
    """The same prefill and decode steps with 2 rows (which do not split
    over 4 "data" ranks) and a cache of 31 positions (which does not split
    over 2 "model" ranks): `ax.constrain` drops both axes, so every rank
    holds all rows of the logits and every position of each cache, within
    3.3e-6 of the largest |value| (at least 1) of the single process's
    (the logits still split their vocabulary over "model")."""
    b, length = L.SERVE_CASES["serve_rep"]
    logits, caches = L.single_serve(arch, "serve_rep")
    pre = f"serve_rep/{arch}"
    for r, rec in enumerate(ranks):
        for j, want in enumerate(logits):
            key = f"{pre}/logits{j}"
            assert rec[f"{key}@idx"][0].tolist() == [0, b], (r, j)
            err = float(np.abs(rec[key] - _block_of(rec, key, want)).max())
            assert err < REP_TOL * max(1.0, float(np.abs(want).max())), \
                (r, j, err)
        for k, want in caches.items():
            key = f"{pre}/cache/{k}"
            blk = _block_of(rec, key, want)
            assert rec[key].shape == blk.shape, (r, k)
            err = float(np.abs(rec[key] - blk).max())
            assert err < REP_TOL * max(1.0, float(np.abs(want).max())), \
                (r, k, err)
    # the caches the 8-row case splits along their length stay whole
    sharded = [k for k in caches if k.rsplit("/", 1)[-1] in ("k", "ckv")]
    assert sharded or arch == "mamba2_370m", arch
    for k in sharded:
        idx = ranks[0][f"{pre}/cache/{k}@idx"]
        axis = 2 if arch == "whisper_base" else 1
        assert idx[axis].tolist() == [0, length], (k, idx)
        assert idx[0 if arch != "whisper_base" else 1].tolist() == [0, b], k


# --------------------------------- the dry-run against a rank, pod meshes ---


@pytest.mark.parametrize("kind", L.COUNT_KINDS)
@pytest.mark.parametrize("arch", L.COUNT_ARCHS)
def test_dryrun_count_equals_a_real_ranks(ranks, fake, arch, kind):
    """The fake group's meta count at 4 x 2 equals rank 0's count of the
    same step on a real gloo group: FLOPs, bytes, and every collective's
    kind, bytes and group size, in order."""
    pre = f"count/{arch}/{kind}"
    real = ranks[0]
    for k in ("flops", "bytes", "kinds", "nbytes", "groups"):
        np.testing.assert_array_equal(fake[f"{pre}/{k}"], real[f"{pre}/{k}"],
                                      err_msg=k)
    assert int(real[f"{pre}/flops"]) > 0 and len(real[f"{pre}/kinds"]) > 0


@pytest.mark.parametrize("n", (2, 16, 32))
def test_collective_stats_equals_jax(fake, n):
    """The port's records of a sharded step rendered as HLO lines (kind,
    dtype, shape, ``replica_groups`` of ``n`` ranks): JAX's
    ``collective_stats`` of the lines equals the port's of the records,
    by kind."""
    import json

    want = json.loads(str(fake[f"stats/{n}/jax"]))
    got = json.loads(str(fake[f"stats/{n}/port"]))
    assert got == want
    assert sum(got["counts"].values()) > 0


def test_production_mesh_equals_jax(fake):
    for tag in ("pod1", "pod2"):
        assert str(fake[f"mesh/{tag}/port"]) == str(fake[f"mesh/{tag}/jax"])


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in FAKE_CELLS])
def test_pod2_cell_gives_a_record(fake, cell):
    """One cell per family and step kind at pod2: full widths, depth cut
    to one pattern period (plus the prologue), JAX's exact-counting probe
    settings, a train cell at accum_steps 1: a JAX-schema record."""
    import json

    rec = json.loads(str(fake[f"pod2/{cell}"]))
    assert rec["status"] == "ok" and rec["mesh"] == "pod2"
    assert rec["n_chips"] == 512
    coll = rec["collectives"]
    assert set(coll) == {"wire_bytes", "counts", "total_wire_bytes"}
    assert coll["total_wire_bytes"] > 0
    assert rec["roofline"]["collective_s"] > 0
    assert rec["roofline"]["flops"] > 0 and rec["cost_analysis"]["flops"] > 0


def test_jax_pod_dryrun_raises_where_the_port_gives_a_record(fake):
    """The reference's fault (ROADMAP Queue 3): JAX's ``lower_cell`` on
    pod1 (granite_8b, decode_32k, 2 layers) raises ``constrain``'s
    ValueError; the port's same cell gives a record."""
    import json

    assert "Auto axes" in str(fake["jax_pod1/error"])
    rec = json.loads(str(fake["port_pod1"]))
    assert rec["status"] == "ok" and rec["n_chips"] == 256


def test_no_functional_collectives_raises_on_a_dtensor_rule(fake):
    assert "_c10d_functional" in str(fake["guard/error"])
