"""PyTorch port: the serve path over the zoo's other families equals the
JAX package's.

Phi-3.5-MoE's smoke config (the MoE FFN on every layer, top-2 of 4
experts) runs the churn trace of ``tests/test_torch_serve_sched.py``
(arrivals, cancels, zipf probes, 3 live lanes) through both packages'
``ServeScheduler`` from the same weights, under eager maintenance and
under ``deferred`` drained by the worker: every request's tokens and
flags, the trace summary, and the pager's stats, free list and arena must
be equal.  The JAX side runs with x64 in a subprocess once per test run
(`_torch_parity.jax_npz`).

Both gates admit what JAX's admit (``dense``, ``moe`` and ``vlm`` without
MLA).  A VLM admission fails on both sides at the first step that admits
it — JAX's prefill asserts on the missing vision embeddings (a fault of
the reference, ROADMAP Queue 3); the port raises a ValueError naming
them — and DeepSeek-V2 (MLA) and Mamba2 (SSD) are refused at
construction.
"""

import dataclasses

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.serve import SchedulerConfig, ServeScheduler, synth_trace
from repro_torch.serving import LockstepServeEngine, PagerConfig, ServeEngine

from _torch_parity import (
    check_pager, jax_npz, prefixed, serve_model, serve_prelude,
    few_jax_executables,  # noqa: F401  (autouse)
)

ARCH = "phi3_5_moe_42b"
PAGER = dict(num_pages=128, page_size=4, max_blocks=128, tree_height=4)
LEGS = {"eager": PAGER,
        "deferred": dict(PAGER, maintenance="deferred", maint_high_water=6)}
TRACE = dict(arrive_p=0.6, prompt_lens=(3, 9), max_new=(3, 7), cancel_p=0.25,
             probes_per_step=12)
SUMMARY_KEYS = ("submitted", "finished", "rejected", "decode_tokens", "steps")

_JAX = r'''
from repro.serve import SchedulerConfig, ServeScheduler, synth_trace
from repro.serving import PagerConfig

for leg, pc in LEGS.items():
    sch = ServeScheduler(cfg, params, PagerConfig(**pc),
                         SchedulerConfig(max_live=3))
    summary = sch.run_trace(synth_trace(14, seed=11, vocab=cfg.vocab_size,
                                        **TRACE))
    for sid, req in sch.active.items():
        rec[f"{leg}/tokens/{sid}"] = np.asarray(req.out, np.int64)
        rec[f"{leg}/flags/{sid}"] = np.asarray([req.done, req.cancelled,
                                                req.admit_step])
    rec[f"{leg}/summary"] = np.asarray([summary[k] for k in SUMMARY_KEYS])
    pager_state(leg, sch.pager)

vcfg = get_smoke_config("internvl2_2b")
sch = ServeScheduler(vcfg, api(vcfg).init_params(jax.random.PRNGKey(0)),
                     PagerConfig(**PAGER), SchedulerConfig(max_live=2))
sch.submit(np.arange(1, 6, dtype=np.int32), max_new=3)
try:
    sch.step()
    rec["vlm/error"] = np.asarray("")
except AssertionError as e:
    rec["vlm/error"] = np.asarray(type(e).__name__)
'''


@pytest.fixture(scope="module")
def jax_serve(tmp_path_factory):
    consts = dict(LEGS=LEGS, PAGER=PAGER, TRACE=TRACE,
                  SUMMARY_KEYS=SUMMARY_KEYS)
    head = "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    return jax_npz(tmp_path_factory, "torch_serve_zoo",
                   head + serve_prelude(ARCH) + _JAX)


@pytest.mark.parametrize("leg", list(LEGS))
def test_moe_churn_trace_equals_jax(jax_serve, leg):
    """Phi-3.5-MoE's smoke model through the scheduler: tokens, flags,
    summary and pager state equal JAX's, eager and deferred."""
    rec = jax_serve
    model = serve_model(rec, ARCH)
    cfg = model.cfg
    assert cfg.family == "moe" and hasattr(model.layers[0].ffn, "router")
    sch = ServeScheduler(cfg, model, PagerConfig(**LEGS[leg],
                                                 engine="lockstep"),
                         SchedulerConfig(max_live=3))
    summary = sch.run_trace(synth_trace(14, seed=11, vocab=cfg.vocab_size,
                                        **TRACE))
    assert set(sch.active) == {int(k) for k in prefixed(rec, f"{leg}/tokens")}
    for sid, req in sch.active.items():
        assert req.out == rec[f"{leg}/tokens/{sid}"].tolist(), (leg, sid)
        assert [req.done, req.cancelled, req.admit_step] == \
            rec[f"{leg}/flags/{sid}"].tolist(), (leg, sid)
    np.testing.assert_array_equal(rec[f"{leg}/summary"],
                                  [summary[k] for k in SUMMARY_KEYS])
    check_pager(rec, leg, sch.pager)
    assert summary["finished"] >= 5
    assert len(sch.pager.free_pages) == PAGER["num_pages"]
    if leg == "deferred":
        assert sch.worker.stats()["drains"] > 0


def test_vlm_admission_fails_on_both_sides(jax_serve):
    """The scheduler admits the VLM family, as JAX's does, and its first
    admitting step fails: JAX's prefill asserts (no vision embeddings reach
    it), the port's raises a ValueError naming them."""
    assert str(jax_serve["vlm/error"]) == "AssertionError"
    cfg = get_smoke_config("internvl2_2b")
    model = Transformer(cfg, device="cpu", seed=0)
    sch = ServeScheduler(cfg, model, PagerConfig(**PAGER, engine="lockstep"),
                         SchedulerConfig(max_live=2))
    sch.submit(np.arange(1, 6, dtype=np.int32), max_new=3)
    with pytest.raises(ValueError, match="vision_embeds"):
        sch.step()


@pytest.mark.parametrize("name", ["deepseek_v2_236b", "mamba2_370m"])
def test_unservable_configs_refused_by_both_gates(name):
    """MLA (DeepSeek-V2) and SSD (Mamba2) are refused by the JAX scheduler
    and engine (their asserts) and by the port's (NotImplementedError)
    before a model or pager is touched."""
    from repro.configs import get_smoke_config as j_smoke
    from repro.serve import ServeScheduler as JScheduler
    from repro.serving import LockstepServeEngine as JEngine
    from repro.serving import PagerConfig as JPagerConfig

    jcfg = j_smoke(name)
    for cls in (JScheduler, JEngine):
        with pytest.raises(AssertionError):
            cls(jcfg, None, JPagerConfig())
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    for cls in (ServeScheduler, ServeEngine, LockstepServeEngine):
        with pytest.raises(NotImplementedError, match="refused"):
            cls(cfg, None, PagerConfig())
