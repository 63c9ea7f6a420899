"""PyTorch port: the trainer (``repro_torch.train``, ``optim``, ``data``,
``checkpoint``, ``launch.train``) against the JAX package's, on every smoke
config with the JAX weights carried over.

The JAX oracle is ``make_train_step`` under a plain ``jax.jit`` (its
``launch/train.py`` fails on any mesh, ROADMAP Queue 3), run once per
arch per test run (`_torch_parity.jax_train_leg`).  Tolerances:

- gradients of ``loss_fn``: each leaf within GRAD_TOL of its largest
  |g_jax| (XLA and torch sum the products in other orders);
- each of TRAIN_STEPS train steps, taken from JAX's state before it:
  its ``loss``, ``grad_norm`` and ``lr`` within METRIC_TOL relative; the
  moments after it each leaf within GRAD_TOL of its largest |value|; the
  parameters within ``2 lr_max`` elementwise (Adam's normalised step
  turns a rounding difference in a near-zero gradient into up to a whole
  ``lr`` each way) and within PARAM_MEAN_TOL on the mean |difference|;
- the TRAIN_STEPS steps run through from the initial weights: the
  parameters after the last within ``2 K lr_max`` elementwise.  Run
  through, nothing else is held: the few parameters that move apart at a
  step move every later gradient, and a MoE router near a tie then picks
  another expert (Phi-3.5-MoE's smoke model: 67 parameters apart after
  step 1 flip a route at step 2, whose gradient norm lands 1.8 % apart
  and moves 219,885 of 324,800 parameters; taken from JAX's state, each
  step agrees as above).

``remat`` (both policies) must give gradients equal bit for bit to
``remat`` off, and the CLI killed at step 4 and resumed to 8 must equal 8
steps run through, bit for bit (port against port).
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (
    TRAIN_B,
    TRAIN_OPT,
    TRAIN_STEPS,
    few_jax_executables,  # noqa: F401  (autouse)
    jax_train_leg,
    port_model,
    prefixed,
    train_data,
    train_legs,
)
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.data import DataConfig, batch_at_step, to_device
from repro_torch.launch import train as TR
from repro_torch.models import blocks as B
from repro_torch.models.registry import api
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import make_train_step
from repro_torch.train.step import microbatch

GRAD_TOL = 2e-4          # measured worst: 4.6e-5 (Jamba)
METRIC_TOL = 1e-5
PARAM_MEAN_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """Smoke-size steps gain nothing from intra-op threads, and the
    parallel test workers' threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, rows: int, step: int) -> dict:
    return to_device(batch_at_step(DataConfig(**train_data(cfg, rows)),
                                   step), "cpu")


def _close_leaves(got: dict, want: dict, tol: float, what: str) -> None:
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k, w in want.items():
        g = got[k].detach().float().numpy()
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        err = float(np.abs(g - w).max())
        assert err <= tol * float(np.abs(w).max()), (what, k, err)


def _state(rec, arch: str, tag: str, k: int):
    """(model, opt state) holding JAX's state before step ``k`` of leg
    ``tag``: the initial weights and zero moments at k = 0."""
    if k == 0:
        model = port_model(rec, arch)
        return model, adamw_init(AdamWConfig(**TRAIN_OPT),
                                 dict(model.named_parameters()))
    pre = f"{tag}/s{k - 1}"
    model = port_model({f"param/{n}": v for n, v in
                        prefixed(rec, f"{pre}/param").items()}, arch)
    opt = {key: {n: torch.tensor(v) for n, v in
                 prefixed(rec, f"{pre}/{key}").items()}
           for key in ("m", "v")}
    opt["step"] = torch.tensor(k, dtype=torch.int32)
    return model, opt


def _check_params(rec, tag: str, k: int, model, steps: int) -> None:
    """The port's parameters after step ``k`` against JAX's: within ``2
    steps lr_max`` elementwise, and for one step within PARAM_MEAN_TOL on
    the mean."""
    pre = f"{tag}/s{k}"
    want = prefixed(rec, f"{pre}/param")
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    diff = np.concatenate([np.abs(got[n] - w).ravel()
                           for n, w in want.items()])
    bound = 2 * steps * TRAIN_OPT["lr"]
    assert diff.max() <= bound, (pre, float(diff.max()), bound)
    if steps == 1:
        assert diff.mean() <= PARAM_MEAN_TOL, (pre, float(diff.mean()))


def _check_leg(rec, arch: str, tag: str, accum: int, rows: int) -> None:
    """Each step from JAX's state before it (metrics within METRIC_TOL,
    moments after it within GRAD_TOL, parameters by `_check_params`),
    then TRAIN_STEPS steps run through from the initial weights (the
    parameters after the last, at 2 K lr_max)."""
    cfg = get_smoke_config(arch)
    step = make_train_step(cfg, AdamWConfig(**TRAIN_OPT), accum_steps=accum)
    for k in range(TRAIN_STEPS):
        model, opt = _state(rec, arch, tag, k)
        model, opt, met = step(model, opt, _batch(cfg, rows, k))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[key]),
                                       rec[f"{tag}/{key}"][k],
                                       rtol=METRIC_TOL, err_msg=(k, key))
        assert int(opt["step"]) == k + 1
        for key in ("m", "v"):
            _close_leaves(opt[key], prefixed(rec, f"{tag}/s{k}/{key}"),
                          GRAD_TOL, key)
        _check_params(rec, tag, k, model, 1)
    model, opt = _state(rec, arch, tag, 0)
    for k in range(TRAIN_STEPS):
        model, opt, _ = step(model, opt, _batch(cfg, rows, k))
    assert int(opt["step"]) == TRAIN_STEPS
    _check_params(rec, tag, TRAIN_STEPS - 1, model, TRAIN_STEPS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_trainer_matches_jax(arch, tmp_path_factory):
    """On one JAX leg of ``arch`` (one test, so no worker waits on
    another's leg): ``torch.autograd.grad`` of the port's ``loss_fn``
    against ``jax.grad(loss_fn)`` on the same weights and step-0 batch,
    then TRAIN_STEPS ``make_train_step`` steps against JAX's under
    ``jax.jit`` at accum_steps 1 and, for ACCUM_ARCHS (a dense and a MoE
    config, whose expert capacity sees each microbatch's tokens, so the
    row order shows), at accum_steps 2 over 4 rows (microbatch a takes
    rows 2b + a): metrics, moments, parameters."""
    rec = jax_train_leg(tmp_path_factory, arch)
    model = port_model(rec, arch).requires_grad_(True)
    names, params = zip(*model.named_parameters())
    loss = api(model.cfg).loss_fn(model, _batch(model.cfg, TRAIN_B, 0))
    grads = torch.autograd.grad(loss, params)
    _close_leaves(dict(zip(names, grads)), prefixed(rec, "grad"), GRAD_TOL,
                  "grad")
    for tag, accum, rows in train_legs(arch):
        _check_leg(rec, arch, tag, accum, rows)


class _MMCount(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _grads(cfg, rows: int = 2):
    """(loss, gradients, block_train calls, mm launches) of one backward
    of ``cfg``'s smoke model from seed 0."""
    m = api(cfg)
    model = m.init_params(device="cpu", seed=0).requires_grad_(True)
    names, params = zip(*model.named_parameters())
    batch = _batch(cfg, rows, 0)
    calls = []
    orig = B.block_train

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    B.block_train = counted
    try:
        with _MMCount() as mm:
            loss = m.loss_fn(model, batch)
            grads = torch.autograd.grad(loss, params)
    finally:
        B.block_train = orig
    return loss, dict(zip(names, grads)), len(calls), mm.mm


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_gradients_bit_equal(arch, policy):
    """``remat`` on gives the loss and every gradient equal bit for bit to
    ``remat`` off; it recomputes (a decoder's blocks run again in the
    backward), and a decoder's "dots" keeps the weight products (no
    ``mm`` runs again; the encoder-decoder keeps only inputs, as JAX's
    does)."""
    base = dataclasses.replace(get_smoke_config(arch), remat=False)
    loss0, g0, calls0, mm0 = _grads(base)
    cfg = dataclasses.replace(base, remat=True, remat_policy=policy)
    loss1, g1, calls1, mm1 = _grads(cfg)
    assert torch.equal(loss0, loss1)
    assert set(g0) == set(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    if base.family != "audio":
        assert calls1 > calls0 == base.num_layers
    if policy == "nothing" or base.family == "audio":
        assert mm1 > mm0        # the backward recomputed the products
    else:
        assert mm1 == mm0       # ... and none of them under "dots"


def test_microbatch_takes_rows_b_times_a_plus_a():
    """JAX's (B, ...) -> (B/A, A, ...) -> swap: microbatch a is rows
    b * A + a."""
    x = torch.arange(12).reshape(6, 2)
    for a in range(3):
        got = microbatch({"x": x}, 3, a)["x"]
        assert torch.equal(got, x[a::3]), a


def test_train_step_leaves_no_grad_fields():
    """The step differentiates with ``torch.autograd.grad``: no ``.grad``
    is written (none can go stale), and the metrics are 0-d tensors on
    the model's device."""
    cfg = get_smoke_config("granite_8b")
    model = api(cfg).init_params(device="cpu", seed=0)
    ocfg = AdamWConfig()
    step = make_train_step(cfg, ocfg)
    opt = adamw_init(ocfg, dict(model.named_parameters()))
    for k in range(2):
        model, opt, met = step(model, opt, _batch(cfg, 2, k))
    assert all(p.grad is None for p in model.parameters())
    assert int(opt["step"]) == 2
    for key in ("loss", "grad_norm", "lr"):
        assert met[key].shape == () and met[key].device == model.device


CLI = ["--arch", "granite_8b", "--smoke", "--device", "cpu", "--batch", "2",
       "--seq", "32", "--log-every", "100"]


def test_cli_kill_and_resume_bit_exact(tmp_path):
    """4 steps + checkpoint, then ``--resume`` to 8, equals 8 steps run
    through, bit for bit (warmup_steps=5 > 4, so the two runs'
    schedules agree)."""
    a = TR.main(CLI + ["--steps", "8"])
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "100"]
    TR.main(CLI + ["--steps", "4"] + ck)
    c = TR.main(CLI + ["--steps", "8", "--resume"] + ck)
    pa, pc = dict(a.named_parameters()), dict(c.named_parameters())
    assert set(pa) == set(pc)
    for k in pa:
        assert torch.equal(pa[k], pc[k]), k


def test_cli_mesh_raises():
    """A mesh needs a process group of its size (tests/test_torch_parallel.py
    runs one): with none, and no backend to start one, the CLI raises."""
    with pytest.raises(ValueError, match="ranks of a process group"):
        TR.main(CLI + ["--steps", "1", "--data", "2"])


def test_cli_runs_on_the_card_unless_told():
    """Without ``--device`` the trainer asks for the card: with none it
    raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would take it")
    argv = [a for a in CLI if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.main(argv + ["--steps", "1"])
