"""PyTorch port: the continuous-batching serve scheduler equals the JAX
package's.

The churn leg replays ``tests/test_serve_sched.py::
test_churn_trace_matches_dense_oracle``'s trace (arrivals, cancels, zipf
probes, ``deferred`` maintenance drained by the worker) in both packages
from the same smoke-model weights; the JAX side runs with x64 in a
subprocess once per test run (`_torch_parity.jax_npz`).  Every request's
tokens and flags, the ``ServeStats`` counters (latencies aside), worker
and pager stats, the free list, a mid-trace ``scan`` and the final arena
arrays must be equal.  The host-side pieces the port copies (op combining,
the trace generator, the stats classes) are held against their JAX
originals in process.
"""

import json

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import Transformer
from repro_torch.obs.stats import LATENCY_RESERVOIR, ScanStats, ServeStats
from repro_torch.serve import (
    SchedulerConfig,
    ServeScheduler,
    combine_ops,
    dedupe_lookups,
    synth_trace,
)
from repro_torch.serving import (
    LockstepServeEngine,
    PagerConfig,
    ServeEngine,
    ShardedPagerConfig,
)

from _torch_parity import (
    SERVE_PRELUDE, SHARDED_CHURN, SHARDED_TRACE, check_pager,
    check_sharded_pager, jax_npz, jax_sharded, prefixed, record_step_views,
    serve_model,
)

STATIC = dict(num_pages=64, page_size=4, max_blocks=64,
              tree_height=4)
CHURN = dict(num_pages=128, page_size=4, max_blocks=128,
             tree_height=4, maintenance="deferred", maint_high_water=6)
TRACE = dict(arrive_p=0.6, prompt_lens=(3, 9), max_new=(3, 7), cancel_p=0.25,
             probes_per_step=12)
CHURN_SPLIT = 7    # the mid-trace scan runs after this many plan steps
OBS_KEYS = ("steps", "flushes", "pending_hwm", "queue_hwm", "admitted",
            "admit_wait", "combined", "view_hits", "view_builds",
            "probe_queries", "probe_hits")
WORKER_KEYS = ("drains", "rounds", "rebuilds", "expands", "merges",
               "last_drain_step")
SUMMARY_KEYS = ("submitted", "finished", "rejected", "decode_tokens", "steps")

_JAX_CHURN = r'''
from repro.serve import SchedulerConfig, ServeScheduler, synth_trace
from repro.serving import PagerConfig

sch = ServeScheduler(cfg, params, PagerConfig(**CHURN),
                     SchedulerConfig(max_live=3))
plans = synth_trace(14, seed=11, vocab=cfg.vocab_size, **TRACE)
sch.run_trace(plans[:CHURN_SPLIT], drain=False)
pages = sch.scan(list(range(sch._next_id)))
for sid, p in pages.items():
    rec[f"scan/{sid}"] = np.asarray(p, np.int64)
summary = sch.run_trace(plans[CHURN_SPLIT:])
for sid, req in sch.active.items():
    rec[f"churn/tokens/{sid}"] = np.asarray(req.out, np.int64)
    rec[f"churn/flags/{sid}"] = np.asarray([req.done, req.cancelled,
                                            req.admit_step])
obs = sch.obs.asdict()
rec["churn/obs"] = np.asarray([obs[k] for k in OBS_KEYS])
rec["churn/worker"] = np.asarray([sch.worker.stats()[k] for k in WORKER_KEYS])
rec["churn/summary"] = np.asarray([summary[k] for k in SUMMARY_KEYS])
pager_state("churn", sch.pager)
'''


@pytest.fixture(scope="module")
def jax_churn(tmp_path_factory):
    consts = dict(CHURN=CHURN, TRACE=TRACE, CHURN_SPLIT=CHURN_SPLIT,
                  OBS_KEYS=OBS_KEYS, WORKER_KEYS=WORKER_KEYS,
                  SUMMARY_KEYS=SUMMARY_KEYS)
    head = "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    return jax_npz(tmp_path_factory, "torch_serve_sched_churn",
                   head + SERVE_PRELUDE + _JAX_CHURN)


# ---------------------------------------------------------------- churn ---


def test_churn_trace_equals_jax(jax_churn):
    """Every request's tokens and flags, the ServeStats counters, worker
    and pager stats, free list, a mid-trace scan and the final arena equal
    JAX's; ops were combined, the worker drained, and the decode path ran
    no inline maintenance."""
    rec = jax_churn
    model = serve_model(rec)
    cfg = model.cfg
    sch = ServeScheduler(cfg, model, PagerConfig(**CHURN, engine="lockstep"),
                         SchedulerConfig(max_live=3))
    plans = synth_trace(14, seed=11, vocab=cfg.vocab_size, **TRACE)
    sch.run_trace(plans[:CHURN_SPLIT], drain=False)
    pages = sch.scan(list(range(sch._next_id)))
    assert set(pages) == {int(k) for k in prefixed(rec, "scan")}
    for sid, p in pages.items():
        np.testing.assert_array_equal(p, rec[f"scan/{sid}"], err_msg=sid)
    summary = sch.run_trace(plans[CHURN_SPLIT:])
    assert set(sch.active) == {int(k) for k in prefixed(rec, "churn/tokens")}
    for sid, req in sch.active.items():
        assert req.out == rec[f"churn/tokens/{sid}"].tolist(), sid
        assert [req.done, req.cancelled, req.admit_step] == \
            rec[f"churn/flags/{sid}"].tolist(), sid
    obs = sch.obs.asdict()
    np.testing.assert_array_equal(rec["churn/obs"], [obs[k] for k in OBS_KEYS])
    np.testing.assert_array_equal(rec["churn/worker"],
                                  [sch.worker.stats()[k] for k in WORKER_KEYS])
    np.testing.assert_array_equal(rec["churn/summary"],
                                  [summary[k] for k in SUMMARY_KEYS])
    check_pager(rec, "churn", sch.pager)
    assert summary["finished"] >= 5 and obs["combined"] > 0
    assert sch.worker.stats()["drains"] > 0
    assert sch.pager.stats["inline_maint"] == 0
    assert len(sch.pager.free_pages) == CHURN["num_pages"]
    assert sch.scan_obs.asdict()["lanes"] == len(pages)


def test_scheduler_matches_lockstep_on_static_trace():
    """No churn + eager maintenance: the scheduler is bit-identical to the
    legacy lockstep loop (tokens and pager searches)."""
    cfg = get_smoke_config("granite_8b")
    model = Transformer(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 3, 7)]
    outs, searches = [], []
    for cls in (LockstepServeEngine, ServeEngine):
        eng = cls(cfg, model, PagerConfig(**STATIC, engine="lockstep"),
                  max_batch=4)
        sids = [eng.submit(p, max_new=6) for p in prompts]
        for _ in range(8):
            eng.step()
        assert all(eng.active[s].done for s in sids)
        outs.append([eng.active[s].out for s in sids])
        searches.append(eng.pager.stats["searches"])
        assert len(eng.pager.free_pages) == STATIC["num_pages"]
    assert outs[0] == outs[1]
    assert searches[0] == searches[1]


# ------------------------------------------ host-side copies vs the JAX ---


def test_combine_ops_and_dedupe_equal_jax():
    from repro.serve.combine import combine_ops as j_combine
    from repro.serve.combine import dedupe_lookups as j_dedupe

    rng = np.random.default_rng(5)
    for _ in range(20):
        n = int(rng.integers(0, 40))
        kinds = rng.integers(0, 3, n).astype(np.int32)
        keys = rng.integers(1, 12, n).astype(np.int32)
        pays = rng.integers(0, 100, n).astype(np.int32)
        for a, b in zip(j_combine(kinds, keys, pays),
                        combine_ops(kinds, keys, pays)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(j_dedupe(keys), dedupe_lookups(keys)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_synth_trace_equals_jax():
    from repro.serve.trace import synth_trace as j_trace

    kw = dict(seed=3, arrive_p=0.6, burst=2, prompt_lens=(16, 512),
              max_new=(8, 32), cancel_p=0.25, probes_per_step=32,
              vocab=49152)
    for a, b in zip(j_trace(24, **kw), synth_trace(24, **kw)):
        assert len(a.arrivals) == len(b.arrivals) and a.cancels == b.cancels
        for (pa, ma), (pb, mb) in zip(a.arrivals, b.arrivals):
            np.testing.assert_array_equal(pa, pb)
            assert ma == mb
        np.testing.assert_array_equal(a.probe_refs, b.probe_refs)


def test_serve_and_scan_stats_equal_jax():
    """The numpy ServeStats / ScanStats fold the same samples to the same
    counters and percentiles as the JAX pytrees, across a reservoir wrap."""
    from repro.obs.stats import LATENCY_RESERVOIR as J_RES
    from repro.obs.stats import ScanStats as JScan
    from repro.obs.stats import ServeStats as JServe

    assert J_RES == LATENCY_RESERVOIR
    rng = np.random.default_rng(2)
    js, ts = JServe.zero(), ServeStats.zero()
    for i in range(LATENCY_RESERVOIR + 37):
        kw = dict(pending=int(rng.integers(0, 9)), flushed=bool(i % 5 == 0),
                  queue_depth=int(rng.integers(0, 4)),
                  admitted=int(rng.integers(0, 2)),
                  admit_wait=int(rng.integers(0, 3)),
                  combined=int(rng.integers(0, 3)))
        sec = float(rng.random()) * 1e-2
        js, ts = js.record(sec, **kw), ts.record(sec, **kw)
        if i % 50 == 0:
            js, ts = js.record_probe(12, 7), ts.record_probe(12, 7)
    assert js.asdict() == ts.asdict()
    np.testing.assert_array_equal(np.asarray(js.lat_us), ts.lat_us)
    jsc, tsc = JScan.zero(), ScanStats.zero()
    for _ in range(4):
        n = rng.integers(0, 9, 16).astype(np.int32)
        hops = rng.integers(1, 30, 16).astype(np.int32)
        more = rng.random(16) < 0.3
        jsc = jsc.merge(JScan.of(n, hops, more))
        tsc = tsc.merge(ScanStats.of(n, hops, more))
    assert jsc.asdict() == tsc.asdict()


# ------------------------------------------------------ sharded pager ---


@pytest.fixture(scope="module")
def jax_sharded_rec(tmp_path_factory):
    return jax_sharded(tmp_path_factory)


def test_sharded_scheduler_view_counters_equal_jax(jax_sharded_rec):
    """The churn trace over a forest-backed pager (lockstep reads, fused
    frontier): every step's fused-view cache hits and builds, their
    ServeStats totals, every request's tokens and the final pager state
    (every shard's arena) equal the JAX scheduler's; the view was both
    built and reused."""
    from repro_torch.distributed import forest as TF
    from repro_torch.serving import ShardedDeltaPager

    rec = jax_sharded_rec
    model = serve_model(rec)
    TF.reset_fused_view_cache()
    sch = ServeScheduler(model.cfg, model, ShardedPagerConfig(**SHARDED_CHURN),
                         SchedulerConfig(max_live=3))
    assert isinstance(sch.pager, ShardedDeltaPager)
    assert sch.pager.index.capability.fused_forest
    views = record_step_views(sch)
    plans = synth_trace(14, seed=11, vocab=model.cfg.vocab_size,
                        **SHARDED_TRACE)
    sch.run_trace(plans)
    np.testing.assert_array_equal(rec["sched/views"], views)
    obs = sch.obs.asdict()
    np.testing.assert_array_equal(rec["sched/obs"],
                                  [obs["view_hits"], obs["view_builds"]])
    cache = TF.fused_view_cache_stats()
    np.testing.assert_array_equal(rec["sched/cache"],
                                  [cache["builds"], cache["hits"]])
    assert obs["view_hits"] > 0 and obs["view_builds"] > 0
    assert set(sch.active) == {int(k) for k in prefixed(rec, "sched/tokens")}
    for sid, req in sch.active.items():
        assert req.out == rec[f"sched/tokens/{sid}"].tolist(), sid
    check_sharded_pager(rec, "sched", sch.pager)


# ------------------------------------------------------- not yet ported ---


def test_unported_serving_surfaces_raise():
    """metrics(), which raised until obs/export was ported, now returns
    the snapshot in all three forms; the sharded pager, which raised until
    the forest was ported, builds a forest-backed pager."""
    cfg = get_smoke_config("granite_8b")
    model = Transformer(cfg, device="cpu")
    sch = ServeScheduler(cfg, model, PagerConfig(**STATIC))
    snap = sch.metrics()
    assert {"serve", "scan", "maintenance", "pager"} <= set(snap)
    assert json.loads(sch.metrics("json")) == snap
    assert "repro_serve_steps 0" in sch.metrics("prometheus")
    assert json.dumps(sch.obs.asdict())
    sharded = ServeScheduler(cfg, model, ShardedPagerConfig(**STATIC))
    assert sharded.pager.index.backend == "forest"
    assert sharded.pager.index.capability.sharded
