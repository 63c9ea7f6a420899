"""PyTorch port: the data pipeline, AdamW, int8 compression and the
checkpoint manager (``repro_torch.data`` / ``optim`` / ``checkpoint``).

The first seven tests are ``tests/test_data_optim_checkpoint.py`` on the
port.  The rest hold the port to the JAX functions on the same numpy
inputs: ``batch_at_step`` bit for bit; ``cosine_lr`` and ``adamw_update``
in float32 within F32_REL of each array's largest |value|, bf16 moments
within one bf16 step; ``quantize_int8`` exactly; the checkpoint files
byte for byte (bf16 leaves included), and the port restores a
JAX-written bf16 checkpoint, which JAX itself cannot.
"""

import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import DataConfig as JDataConfig
from repro.data import batch_at_step as j_batch_at_step
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_lr as j_cosine_lr
from repro.optim import quantize_int8 as j_quantize_int8
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.data import DataConfig, Pipeline, batch_at_step, to_device
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_lr,
    dequantize_int8,
    quantize_int8,
)

F32_REL = 1e-6


# ------------------------------------ tests/test_data_optim_checkpoint.py ---


def test_data_deterministic_by_step():
    cfg = DataConfig(vocab_size=1000, seq_len=64, global_batch=4, seed=7)
    b1 = batch_at_step(cfg, 5)
    b2 = batch_at_step(cfg, 5)
    assert (b1["tokens"] == b2["tokens"]).all()
    b3 = batch_at_step(cfg, 6)
    assert not (b1["tokens"] == b3["tokens"]).all()
    # next-token labels
    assert (b1["labels"][:, :-1] == b1["tokens"][:, 1:]).all()


def test_pipeline_prefetch_ordering():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=2)
    pipe = Pipeline(cfg, start_step=3)
    try:
        got = [next(pipe) for _ in range(4)]
        assert [s for s, _ in got] == [3, 4, 5, 6]
        want = batch_at_step(cfg, 3)
        assert all((got[0][1][k] == want[k]).all() for k in want)
    finally:
        pipe.close()


def test_adamw_minimizes_quadratic():
    ocfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                       total_steps=200)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(ocfg, params)
    for _ in range(100):
        w = params["w"].requires_grad_(True)
        g, = torch.autograd.grad(torch.sum(w ** 2), w)
        params, state, _ = adamw_update(ocfg, params, {"w": g}, state)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


def test_grad_clip_and_schedule():
    ocfg = AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=10,
                       total_steps=100, min_lr_frac=0.1)
    assert float(cosine_lr(ocfg, torch.tensor(0))) == 0.0
    assert abs(float(cosine_lr(ocfg, torch.tensor(10))) - 1.0) < 1e-6
    assert float(cosine_lr(ocfg, torch.tensor(100))) <= 0.1 + 1e-6
    params = {"w": torch.zeros(3)}
    state = adamw_init(ocfg, params)
    g = {"w": torch.tensor([100.0, 0.0, 0.0])}
    _, _, metrics = adamw_update(ocfg, params, g, state)
    assert float(metrics["grad_norm"]) > 99.0


def test_int8_roundtrip():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(1000).astype(np.float32)) * 5
    q, s = quantize_int8(x)
    err = float(torch.abs(dequantize_int8(q, s) - x).max())
    assert err <= float(s) * 0.51 + 1e-6  # half-ulp of the int8 grid


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": [torch.ones((2, 3)), {"c": torch.tensor(7)}]}
    ck = CheckpointManager(tmp_path, async_save=False)
    ck.save(3, tree, extra={"data_step": 3})
    ck.save(9, tree, extra={"data_step": 9})
    assert latest_step(tmp_path) == 9
    step, tree2, extra = ck.restore(None, tree, device="cpu")
    assert step == 9 and extra["data_step"] == 9
    for x, y in zip(_leaves(tree), _leaves(tree2)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_async_and_gc(tmp_path):
    tree = {"w": torch.zeros(4)}
    ck = CheckpointManager(tmp_path, keep_last=2, async_save=True)
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    ck.wait()
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(steps) == 2 and steps[-1] == "step_00000004"


# ------------------------------------------------------- against JAX -----


@pytest.mark.parametrize("family", ["dense", "vlm", "audio"])
def test_batch_at_step_bit_for_bit(family):
    kw = dict(vocab_size=5000, seq_len=96, global_batch=3, seed=11,
              mean_doc_len=24, family=family, d_model=16, vision_tokens=5,
              encoder_seq=7)
    for step in (0, 1, 17):
        got = batch_at_step(DataConfig(**kw), step)
        want = j_batch_at_step(JDataConfig(**kw), step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    dev = to_device(got, "cpu")
    for k, v in dev.items():
        assert v.dtype == (torch.int32 if k in ("tokens", "labels")
                           else torch.float32)


def test_cosine_lr_matches_jax():
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    steps = np.array([0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 101, 1000],
                     np.int32)
    got = cosine_lr(AdamWConfig(**kw), torch.as_tensor(steps)).numpy()
    want = np.asarray(j_cosine_lr(JAdamWConfig(**kw), jnp.asarray(steps)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=F32_REL, atol=0)


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """One bf16 rounding step at each |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _opt_inputs(rng, step0: int, sdt):
    """A two-leaf tree, its gradients and a state at ``step0`` (moments
    of real size past the first step), as numpy."""
    shapes = {"w": (7, 5), "norm": (5,)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         shapes.items()}
    g = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
         for k, s in shapes.items()}
    g["w"][0, :2] = [1e-9, -1e-9]             # near-zero gradients
    if step0 == 0:
        m = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
        v = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    else:
        m = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
             for k, s in shapes.items()}
        v = {k: (rng.random(s) * 0.05).astype(np.float32)
             for k, s in shapes.items()}
    if sdt == "bfloat16":
        m = {k: x.astype(ml_dtypes.bfloat16) for k, x in m.items()}
        v = {k: x.astype(ml_dtypes.bfloat16) for k, x in v.items()}
    return p, g, m, v


def _torch_of(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(x.copy())


@pytest.mark.parametrize("sdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("step0", [0, 10, 150])
@pytest.mark.parametrize("clip", [0.5, 100.0])
def test_adamw_update_matches_jax(clip, step0, sdt):
    """One update from state step 0 (warm-up), 10 (the cosine) and 150
    (past total_steps), with the clip binding (0.5) or not (100): the
    parameters, moments and metrics against JAX's."""
    kw = dict(lr=1e-2, warmup_steps=10, total_steps=100, grad_clip=clip,
              state_dtype=sdt)
    p, g, m, v = _opt_inputs(np.random.default_rng(step0 + int(clip)),
                             step0, sdt)
    jp, js, jm = j_adamw_update(
        JAdamWConfig(**kw), {k: jnp.asarray(x) for k, x in p.items()},
        {k: jnp.asarray(x) for k, x in g.items()},
        {"m": {k: jnp.asarray(x) for k, x in m.items()},
         "v": {k: jnp.asarray(x) for k, x in v.items()},
         "step": jnp.asarray(step0, jnp.int32)})
    tp, ts, tm = adamw_update(
        AdamWConfig(**kw), {k: _torch_of(x) for k, x in p.items()},
        {k: _torch_of(x) for k, x in g.items()},
        {"m": {k: _torch_of(x) for k, x in m.items()},
         "v": {k: _torch_of(x) for k, x in v.items()},
         "step": torch.tensor(step0, dtype=torch.int32)})
    assert int(ts["step"]) == int(js["step"]) == step0 + 1
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=F32_REL)
    if clip == 0.5:
        assert float(tm["grad_norm"]) > clip      # the clip binds
    for k in p:
        want = np.asarray(jp[k])
        np.testing.assert_allclose(tp[k].numpy(), want, rtol=0,
                                   atol=F32_REL * np.abs(want).max())
        for mom in ("m", "v"):
            got = ts[mom][k].float().numpy()
            want = np.asarray(js[mom][k]).astype(np.float32)
            assert ts[mom][k].dtype == (torch.bfloat16 if sdt == "bfloat16"
                                        else torch.float32)
            if sdt == "float32":
                tol = F32_REL * np.abs(want).max()
            else:
                tol = _bf16_step(want)
            assert (np.abs(got - want) <= tol).all(), (k, mom)


def test_quantize_int8_matches_jax():
    rng = np.random.default_rng(3)
    for x in (rng.standard_normal((64, 33)).astype(np.float32) * 7,
              np.zeros(5, np.float32), np.array([0.5, -1.5, 2.5, 127.0],
                                                np.float32)):
        q, s = quantize_int8(torch.from_numpy(x))
        jq, js = j_quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)


def _trees():
    """The same tree for both packages: nested dict / list / tuple,
    float32, int32 and bf16 leaves (0-d to 3-d)."""
    rng = np.random.default_rng(5)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    bf = rng.standard_normal((2, 3, 5)).astype(ml_dtypes.bfloat16)
    i32 = np.arange(6, dtype=np.int32).reshape(2, 3)
    jt = {"params": {"w": jnp.asarray(f32), "e": jnp.asarray(bf)},
          "opt": [jnp.asarray(i32), {"m": jnp.asarray(bf[0])}],
          "pair": (jnp.asarray(np.float32(2.5)), jnp.asarray(7, jnp.int32))}
    tt = {"params": {"w": torch.from_numpy(f32),
                     "e": _torch_of(bf)},
          "opt": [torch.from_numpy(i32), {"m": _torch_of(bf[0])}],
          "pair": (torch.tensor(2.5), torch.tensor(7, dtype=torch.int32))}
    return jt, tt


def _manifest(d):
    m = json.loads((d / "manifest.json").read_text())
    del m["time"]
    return m


def test_checkpoint_files_match_jax_byte_for_byte(tmp_path):
    jt, tt = _trees()
    JCheckpointManager(tmp_path / "jax", async_save=False).save(
        4, jt, extra={"data_step": 4})
    CheckpointManager(tmp_path / "port", async_save=False).save(
        4, tt, extra={"data_step": 4})
    dj, dt = tmp_path / "jax" / "step_00000004", tmp_path / "port" / \
        "step_00000004"
    names = sorted(p.name for p in dj.iterdir())
    assert names == sorted(p.name for p in dt.iterdir())
    assert _manifest(dj) == _manifest(dt)
    assert _manifest(dt)["leaves"]["params.e"]["dtype"] == "bfloat16"
    for n in names:
        if n != "manifest.json":
            assert (dj / n).read_bytes() == (dt / n).read_bytes(), n
    assert b"'descr': '<V2'" in (dt / "params.e.npy").read_bytes()


def test_port_restores_jax_bf16_checkpoint(tmp_path):
    jt, tt = _trees()
    JCheckpointManager(tmp_path, async_save=False).save(
        2, jt, extra={"data_step": 2})
    step, got, extra = CheckpointManager(tmp_path).restore(None, tt,
                                                           device="cpu")
    assert step == 2 and extra == {"data_step": 2}
    for x, y in zip(_leaves(tt), _leaves(got)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_jax_cannot_restore_its_bf16_checkpoint(tmp_path):
    """Reference fault (ROADMAP Queue 3): JAX's restore hands the ``|V2``
    array of a bf16 leaf to ``device_put``."""
    jt, _ = _trees()
    ck = JCheckpointManager(tmp_path, async_save=False)
    ck.save(1, jt)
    with pytest.raises(TypeError, match="V2"):
        ck.restore(None, jt)


def test_async_save_snapshots_a_copy(tmp_path):
    """The parameters change in place after `save` returns: the async
    write holds the values they had at the call."""
    w = torch.arange(1000, dtype=torch.float32)
    before = w.clone()
    ck = CheckpointManager(tmp_path, async_save=True)
    ck.save(1, {"w": w})
    w.add_(1.0)
    ck.wait()
    _, got, _ = ck.restore(1, {"w": w}, device="cpu")
    assert torch.equal(got["w"], before)


def test_restore_needs_a_device_or_the_card(tmp_path):
    ck = CheckpointManager(tmp_path, async_save=False)
    ck.save(1, {"w": torch.zeros(2)})
    if torch.cuda.is_available():
        pytest.skip("a card is present: restore would take it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ck.restore(1, {"w": None})
