"""PyTorch port: observability (`repro_torch.obs`; mirrors tests/test_obs.py
without its HLO and 8-device legs).

- Read stats: ``ReadStats`` from ``search`` / ``lookup`` (both engines,
  the forest's two dispatches, ``Index``) equal the JAX package's field for
  field on the same inputs; ``buffer_hits`` under ``deferred``.
- ``collect_stats=False`` is free: a read returns the same tuple as the
  bare engine hook and runs the same walks (the stand-in for the JAX
  package's HLO-identity test).
- Trace events, ``write_chrome_trace``, ``capture``; the report CLI on the
  repo's own ``BENCH_*.json``; export text equal to JAX's;
  ``ServeScheduler.metrics()`` equal to JAX's on the same smoke trace.
"""

import contextlib
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import deltatree as JDT
from repro.core import layout
from repro.distributed import forest as JD
from repro.distributed.forest import ForestConfig as JForestConfig
from repro.obs import export as JX
from repro.obs import report as JR
from repro.obs import stats as JS
from repro_torch.api import make_index
from repro_torch.core import deltatree as TDT
from repro_torch.core import engine as TE
from repro_torch.distributed import forest as TD
from repro_torch.kernels import ref as TREF
from repro_torch.obs import export, report, trace
from repro_torch.obs import stats as S

from _torch_parity import (
    SERVE_PRELUDE, assert_stats_equal, jax_npz, np_of, port_cfg, port_fcfg,
    few_jax_executables,  # noqa: F401  (autouse)
    serve_model, stack_stats, to_port,
)

ROOT = Path(__file__).resolve().parent.parent
KEYS = np.arange(10, 400, 7, dtype=np.int64)
JCFG = JDT.TreeConfig(height=4, max_dnodes=256, buf_cap=8, collect_stats=True)


def _queries():
    """Hits, misses and born-resolved ROUTE_LEFT sentinel lanes."""
    return np.asarray(list(KEYS[:6]) + [5, 11, 401, layout.ROUTE_LEFT,
                                        layout.ROUTE_LEFT], np.int32)


# ---------------------------------------------------------- stats tuples ---


def test_stats_of_merge_reduce_equal_jax():
    hops = np.asarray([0, 1, 2, 2, 17, 3], np.int32)
    pad = np.asarray([1, 0, 0, 0, 0, 0], bool)
    bhit = np.asarray([0, 0, 1, 0, 0, 1], bool)
    import torch

    js = JS.SearchStats.of(jnp.asarray(hops), jnp.asarray(pad),
                           jnp.asarray(bhit))
    ts = S.SearchStats.of(torch.as_tensor(hops), torch.as_tensor(pad),
                          torch.as_tensor(bhit))
    assert_stats_equal(js, ts, "of")
    assert_stats_equal(js.merge(js), ts.merge(ts), "merge")
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), js, js.merge(js))
    red = S.SearchStats.reduce(stack_stats([ts, ts.merge(ts)]))
    assert_stats_equal(JS.SearchStats.reduce(jst), red, "reduce")
    assert ts.asdict() == js.asdict()
    assert_stats_equal(S.SearchStats.zero().merge(ts), ts, "zero")
    jr = JS.RouterStats.of(jnp.asarray([3, 1], jnp.int32), 2)
    tr = S.RouterStats.of(torch.as_tensor([3, 1], dtype=torch.int32), 2)
    assert_stats_equal(jr, tr, "router")
    assert_stats_equal(jr.merge(jr), tr.merge(tr), "router merge")
    assert tr.asdict() == jr.asdict() and tr.skew() == jr.skew()
    assert_stats_equal(
        JS.RouterStats.reduce(jax.tree.map(lambda *x: jnp.stack(x), jr, jr)),
        S.RouterStats.reduce(stack_stats([tr, tr])), "router reduce")
    assert_stats_equal(S.RouterStats.zero(2).merge(tr), tr, "router zero")


def test_reduce_semantics_max_rounds_sum_work():
    import torch

    a = S.SearchStats.of(torch.tensor([1, 1], dtype=torch.int32),
                         torch.zeros(2, dtype=torch.bool),
                         torch.zeros(2, dtype=torch.bool))
    b = S.SearchStats.of(torch.tensor([3, 2], dtype=torch.int32),
                         torch.zeros(2, dtype=torch.bool),
                         torch.ones(2, dtype=torch.bool))
    red = S.SearchStats.reduce(stack_stats([a, b]))
    assert int(red.rounds) == int(red.hops_max) == 3    # critical path
    assert int(red.queries) == 4 and int(red.hops_sum) == 7  # work sums
    assert int(red.buffer_hits) == 2 and int(red.hops_hist.sum()) == 4


def test_maintenance_stats_rehomed():
    import repro_torch.maintenance
    import repro_torch.maintenance.stats
    import repro_torch.obs

    assert repro_torch.obs.MaintenanceStats is S.MaintenanceStats
    assert repro_torch.maintenance.MaintenanceStats is S.MaintenanceStats
    assert repro_torch.maintenance.stats.MaintenanceStats is \
        S.MaintenanceStats


# ------------------------------------------------------ engine dispatch ---


@pytest.mark.parametrize("engine", ["scalar", "lockstep"])
@pytest.mark.parametrize("read", ["search", "lookup"])
def test_tree_read_stats_equal_jax(engine, read):
    jcfg = dataclasses.replace(JCFG, engine=engine)
    jt = JDT.bulk_build(jcfg, KEYS)
    cfg, t = to_port(jcfg, jt)
    q = _queries()
    jfn = JDT.search_jit if read == "search" else JDT.lookup_jit
    tfn = TDT.search_batch if read == "search" else TDT.lookup_batch
    jo, to = jfn(jcfg, jt, jnp.asarray(q)), tfn(cfg, t, q)
    assert len(to) == len(jo)
    for a, b in zip(jo[:-1], to[:-1]):
        np.testing.assert_array_equal(np_of(b), np.asarray(a))
    rs = to[-1]
    assert isinstance(rs, S.ReadStats) and rs.router is None
    assert rs.transfers is None           # collect_transfers is off
    assert_stats_equal(jo[-1], rs, f"{engine} {read}")
    hops = np_of(to[-2])
    s = rs.search
    assert int(s.pad_lanes) == 2 and int(s.hops_sum) == hops.sum()
    assert int(s.rounds) == hops.max() == int(s.hops_max)
    occ = np_of(s.occupancy)
    assert all(occ[r] == (hops > r).sum() for r in range(occ.size))


def test_hop_histogram_parity_across_engines():
    q = _queries()
    outs = [TDT.search_batch(dataclasses.replace(port_cfg(JCFG),
                                                 engine=e),
                             TDT.bulk_build(port_cfg(JCFG), KEYS,
                                            device="cpu"), q)
            for e in ("scalar", "lockstep")]
    for a, b in zip(outs[0][:2], outs[1][:2]):
        np.testing.assert_array_equal(np_of(a), np_of(b))
    assert_stats_equal(outs[0][2], outs[1][2], "engines")


def test_buffer_hits_under_deferred_maintenance():
    """Items parked in overflow buffers (I5') count as buffer hits, as in
    the JAX package, on the same tree."""
    jcfg = dataclasses.replace(JCFG, maintenance="deferred",
                               engine="lockstep")
    jt = JDT.bulk_build(jcfg, KEYS)
    fresh = np.asarray([k for k in range(11, 30) if k not in set(KEYS)],
                       np.int32)
    jt, res, _ = JDT.update_batch(
        jcfg, jt, jnp.full(fresh.shape, JDT.OP_INSERT, jnp.int32),
        jnp.asarray(fresh))
    assert bool(np.asarray(res).all()) and int(jnp.sum(jt.bcount)) > 0
    q = np.concatenate([fresh, KEYS[:4].astype(np.int32)])
    jo = JDT.search_jit(jcfg, jt, jnp.asarray(q))
    cfg, t = to_port(jcfg, jt)
    found, _, rs = TDT.search_batch(cfg, t, q)
    assert bool(np_of(found).all())
    expected = int((np_of(found) & np_of(TDT.buffered_member(cfg, t, q)))
                   .sum())
    assert expected > 0 and int(rs.search.buffer_hits) == expected
    assert_stats_equal(jo[2], rs, "deferred")


@pytest.mark.parametrize("engine", ["scalar", "lockstep"])
def test_collect_stats_false_is_the_bare_read(engine):
    """The stand-in for the JAX HLO-identity test: with collect_stats off
    a read returns exactly the bare engine hook's columns (same tuple
    length and values) and runs the same plain walks; with it on, the same
    columns plus ReadStats, and still no extra walk (the stats derive from
    the columns)."""
    cfg = TDT.TreeConfig(height=4, max_dnodes=256, buf_cap=8, engine=engine)
    t = TDT.bulk_build(cfg, KEYS, device="cpu")
    q = _queries()

    def run(fn):
        TREF.ref_delta_walk_fused.calls = 0
        out = fn()
        return out, TREF.ref_delta_walk_fused.calls

    bare, n_bare = run(lambda: TE.get_engine(engine).lookup(
        cfg, t, TE._keys(t, q)))
    off, n_off = run(lambda: TE.lookup(cfg, t, q))
    srch, n_srch = run(lambda: TE.search(cfg, t, q))
    on, n_on = run(lambda: TE.lookup(
        dataclasses.replace(cfg, collect_stats=True), t, q))
    assert len(off) == 3 and len(srch) == 2 and len(on) == 4
    for a, b, c in zip(bare, off, on):
        np.testing.assert_array_equal(np_of(a), np_of(b))
        np.testing.assert_array_equal(np_of(a), np_of(c))
    assert n_bare == n_off == n_srch == n_on == (engine == "lockstep")
    ix = make_index("deltatree", initial=KEYS, height=4, max_dnodes=256,
                    buf_cap=8, engine=engine, device="cpu")
    assert not ix.collect_stats and len(ix.search(q)) == 2


def test_index_collect_stats_and_touch_fn():
    from repro.api import make_index as jmake_index

    kw = dict(height=4, max_dnodes=256, buf_cap=8, collect_stats=True,
              collect_transfers=True)
    ix = make_index("deltatree", initial=KEYS, device="cpu", **kw)
    jix = jmake_index("deltatree", initial=KEYS, **kw)
    assert ix.collect_stats and jix.collect_stats
    out, jout = ix.search(_queries()), jix.search(jnp.asarray(_queries()))
    assert_stats_equal(jout[2], out[2], "index search")
    assert int(out[2].transfers.pad_lanes) == 2
    touch, jtouch = ix.touch_fn(), jix.touch_fn()
    assert all(touch(int(k)) == jtouch(int(k)) for k in _queries()[:9])
    for backend in ("sorted_array", "pointer_bst", "static_veb"):
        b = make_index(backend, initial=KEYS, device="cpu")
        assert not b.collect_stats and b.touch_fn() is not None
    assert make_index("forest", initial=KEYS, height=4, max_dnodes=64,
                      device="cpu").touch_fn() is None


# ---------------------------------------------------------------- forest ---


def _fcfgs(engine, fused):
    jf = JForestConfig(num_shards=4, fused=fused,
                       tree=dataclasses.replace(
                           JCFG, engine=engine, collect_transfers=True))
    return jf, port_fcfg(jf)


@pytest.mark.parametrize("engine", ["scalar", "lockstep"])
def test_forest_read_stats_equal_jax_and_dispatch_parity(engine):
    """Each dispatch's ReadStats (search, router, transfers) equals JAX's,
    and the fused and the dense dispatch agree; the router's lanes sum to
    the batch and it counts the keys its clamp rewrote."""
    q = np.concatenate([_queries(), np.asarray([-5, 7], np.int32)])
    outs = []
    for fused in (True, False):
        jf, tf = _fcfgs(engine, fused)
        jo = JD.search_batch(jf, JD.bulk_build(jf, KEYS), jnp.asarray(q))
        to = TD.search_batch(tf, TD.bulk_build(tf, KEYS, device="cpu"), q)
        for a, b in zip(jo[:2], to[:2]):
            np.testing.assert_array_equal(np_of(b), np.asarray(a))
        assert_stats_equal(jo[2], to[2], f"{engine} fused={fused}")
        outs.append(to)
    assert_stats_equal(outs[0][2], outs[1][2], "fused vs dense")
    r = outs[0][2].router
    assert int(r.lanes.sum()) == q.size and int(r.batches) == 1
    assert int(r.clamped) == 1 and r.skew() >= 1.0


# ----------------------------------------------------------------- trace ---


def test_trace_gating(monkeypatch):
    monkeypatch.delenv(trace.ENV, raising=False)
    assert not trace.enabled()
    assert isinstance(trace.annotate("x"), contextlib.nullcontext)
    assert isinstance(trace.span("x"), contextlib.nullcontext)
    monkeypatch.setenv(trace.ENV, "1")
    assert trace.enabled()
    with trace.span("obs-test"), trace.annotate("obs-test-inner"):
        pass
    monkeypatch.setenv(trace.ENV, "0")
    assert not trace.enabled()


def test_trace_span_events_and_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setenv(trace.ENV, "1")
    trace.reset_counters()
    trace.reset_events()

    @trace.traced("obs-evt")
    def work():
        return 3

    with trace.span("obs-evt"):
        pass
    assert work() == 3
    evs = trace.events()
    assert len(evs) == 2
    assert all(e["name"] == "obs-evt" and e["ph"] == "X" and e["dur"] >= 0
               for e in evs)
    assert trace.counters()["obs-evt"] == 2
    trace.reset_counters()
    assert trace.counters() == {} and len(trace.events()) == 2
    path = tmp_path / "chrome_trace.json"
    assert trace.write_chrome_trace(str(path)) == 2
    doc = json.loads(path.read_text())
    assert [e["name"] for e in doc["traceEvents"]] == ["obs-evt", "obs-evt"]
    trace.reset_events()
    assert trace.events() == []


def test_trace_counters_thread_safe(monkeypatch):
    import threading

    monkeypatch.setenv(trace.ENV, "1")
    trace.reset_counters()
    n, workers = 2000, 8

    def work():
        for _ in range(n):
            trace.bump("obs-race")

    threads = [threading.Thread(target=work) for _ in range(workers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert trace.counters()["obs-race"] == n * workers
    trace.reset_counters()


def test_trace_capture_writes_a_trace(tmp_path):
    """``capture`` / ``trace_run`` profile a read on the CPU and write a
    Chrome trace that names its ops."""
    import torch

    ix = make_index("deltatree", initial=KEYS, height=4, max_dnodes=256,
                    engine="lockstep", device="cpu")
    found, _ = trace.trace_run(ix.search, _queries(), logdir=str(tmp_path))
    assert int(found.sum()) == 6           # KEYS[:6] hit
    with trace.capture(str(tmp_path)) as prof:
        torch.arange(8).sum()
    files = sorted(tmp_path.glob("trace_*.json"))
    assert len(files) == 2
    doc = json.loads(files[0].read_text())
    assert any("searchsorted" in e.get("name", "") or
               "aten::" in e.get("name", "")
               for e in doc["traceEvents"])
    assert len(prof.key_averages()) > 0


def test_trace_ring_on_the_profilers_clock(tmp_path, monkeypatch):
    """A span's ring event and its ``record_function`` event start within
    100 µs of each other once both are absolute (µs since the Unix epoch;
    the median over five spans, since the first entry pays the profiler's
    warm-up)."""
    import statistics

    import torch

    monkeypatch.setenv(trace.ENV, "1")
    trace.reset_events()
    with trace.capture(str(tmp_path)) as prof:
        for _ in range(5):
            with trace.span("obs-clock"):
                torch.arange(8).sum()
    base = prof.profiler.kineto_results.trace_start_ns() / 1e3
    prof_ts = sorted(base + e.time_range.start for e in prof.events()
                     if e.name == "obs-clock")
    ring_ts = sorted(e["ts"] for e in trace.events()
                     if e["name"] == "obs-clock")
    trace.reset_events()
    assert len(prof_ts) == len(ring_ts) == 5
    assert statistics.median(abs(r - p)
                             for p, r in zip(prof_ts, ring_ts)) < 100


# A small tree's update calls that force every repair kind and ops on the
# one-by-one path: a dense run of inserts (full bottom leaves: buffered
# inserts, Rebalance, Expand), then deletes that thin ΔNodes out (Merge).
_UPDATE_SCRIPT = (
    (1, np.arange(100, 116)),
    (1, np.arange(200, 248, 2)),
    (2, KEYS[:40]),
    (2, np.arange(200, 248, 2)),
)
_REPAIRS = ("maint.rebalance", "maint.expand", "maint.merge")


def _run_update_script(policy):
    """The script's update calls, then a flush.  Returns (the calls'
    results and stats, the live items, the number of calls)."""
    from repro_torch.api import OpBatch

    ix = make_index("deltatree", initial=KEYS, height=4, max_dnodes=256,
                    buf_cap=8, engine="lockstep", maintenance=policy,
                    device="cpu")
    out = []
    for kind, keys in _UPDATE_SCRIPT:
        keys = np.asarray(keys, np.int32)
        ix, res, st = ix.update(OpBatch.mixed(
            np.full(keys.size, kind, np.int32), keys, np.zeros_like(keys)))
        out.append((res.tolist(), st))
    ix, st = ix.flush()
    out.append((None, st))
    return out, ix.live_items(), len(out)


def _inside(ev, outer) -> bool:
    # ring times are float µs since the epoch, good to 0.25 µs there
    return (ev["ts"] >= outer["ts"]
            and ev["ts"] + ev["dur"] <= outer["ts"] + outer["dur"] + 1.0)


@pytest.mark.parametrize("policy", ["eager", "deferred", "budgeted:2"])
def test_update_spans_count_the_repairs(policy, monkeypatch):
    """Under ``REPRO_TRACE=1`` the update path's spans count what
    ``MaintenanceStats`` counts, every repair sits inside a sweep and every
    sweep inside an update call; unset, the same calls record nothing and
    give the same results."""
    monkeypatch.setenv(trace.ENV, "1")
    trace.reset_counters()
    trace.reset_events()
    traced, live, calls = _run_update_script(policy)
    c, evs = trace.counters(), trace.events()
    trace.reset_counters()
    trace.reset_events()
    stats = [st for _, st in traced]
    assert c["maint.rebalance"] == sum(st.rebuilds for st in stats) > 0
    assert sum(st.expands for st in stats) > 0 and c["maint.expand"] >= 1
    assert c["maint.merge"] >= sum(st.merges for st in stats) > 0
    assert c["maint.batch"] == calls
    assert c["maint.seq_ops"] >= 1 and c["maint.seq"] >= 1
    assert "trace.events_dropped" not in c
    by = {n: [e for e in evs if e["name"] == n]
          for n in ("maint.batch", "maint.sweep") + _REPAIRS}
    assert all(by[n] for n in by)
    for n in _REPAIRS:
        assert all(any(_inside(e, s) for s in by["maint.sweep"])
                   for e in by[n]), n
    assert all(any(_inside(s, b) for b in by["maint.batch"])
               for s in by["maint.sweep"])

    monkeypatch.delenv(trace.ENV)
    untraced = _run_update_script(policy)
    assert trace.counters() == {} and trace.events() == []
    assert untraced == (traced, live, calls)


# ---------------------------------------------------------------- report ---


def _bench_files():
    files = sorted(str(p) for p in ROOT.glob("BENCH_*.json"))
    assert len(files) >= 2
    return files


def test_report_render_diff_history_equal_jax(tmp_path, capsys):
    """The port's copy of the report CLI renders, diffs and tracks
    history over the repo's own BENCH files exactly as the JAX one."""
    files = _bench_files()
    runs = [[files[-1]], [files[-1], "--diff", files[0]],
            [files[-1], "--diff", files[0], "--threshold", "0.95"],
            files + ["--history"]]
    for argv in runs:
        outs = []
        for mod in (JR, report):
            path = tmp_path / f"{mod.__name__}.md"
            assert mod.main(argv + ["--out", str(path)]) == 0
            outs.append(path.read_text())
        assert outs[0] == outs[1], argv
        assert outs[1].strip()
    capsys.readouterr()
    assert report.main([files[-1], "--diff", files[0], "--threshold", "2",
                        "--fail-on-regression"]) == JR.main(
        [files[-1], "--diff", files[0], "--threshold", "2",
         "--fail-on-regression"])
    capsys.readouterr()
    with pytest.raises(SystemExit):
        report.main(files[:2])
    capsys.readouterr()


# ---------------------------------------------------------------- export ---


def test_export_text_equal_jax():
    """Snapshot, Prometheus and JSON text of the same stats equal JAX's."""
    import torch

    hops = np.asarray([0, 1, 2, 2], np.int32)
    z = np.zeros(4, bool)
    jcfg = dataclasses.replace(JCFG, collect_transfers=True)
    jt = JDT.bulk_build(jcfg, KEYS)
    cfg, t = to_port(jcfg, jt)
    from repro.obs import transfers as JOT
    from repro_torch.obs import transfers as TOT

    jsnap = JX.snapshot(
        search=JS.SearchStats.of(jnp.asarray(hops), jnp.asarray(z),
                                 jnp.asarray(z)),
        router=JS.RouterStats.of(jnp.asarray([3, 1], jnp.int32), 0),
        transfers=JOT.measure(jcfg, jt, jnp.asarray(_queries())),
        pager={"searches": 7, "hops": 3.5}, none=None)
    tsnap = export.snapshot(
        search=S.SearchStats.of(torch.as_tensor(hops), torch.as_tensor(z),
                                torch.as_tensor(z)),
        router=S.RouterStats.of(torch.tensor([3, 1], dtype=torch.int32), 0),
        transfers=TOT.measure(cfg, t, _queries()),
        pager={"searches": np.int64(7), "hops": torch.tensor(3.5).item()},
        none=None)
    assert tsnap == jsnap and "none" not in tsnap
    assert export.to_prometheus(tsnap) == JX.to_prometheus(jsnap)
    assert export.to_json(tsnap) == JX.to_json(jsnap)
    prom = export.to_prometheus(tsnap)
    assert 'repro_search_hops_hist{index="0"} 1' in prom
    assert "repro_transfers_blocks_b16 " in prom
    assert export.to_prometheus({}) == ""


# ------------------------------------------------------------- metrics ---

CHURN = dict(num_pages=128, page_size=4, max_blocks=128, tree_height=4,
             maintenance="deferred", maint_high_water=6)
TRACE = dict(arrive_p=0.6, prompt_lens=(3, 9), max_new=(3, 7), cancel_p=0.25,
             probes_per_step=12)

_JAX_METRICS = r'''
import dataclasses, json
from repro.api import make_index
from repro.serve import SchedulerConfig, ServeScheduler, synth_trace
from repro.serving import PagerConfig

pc = PagerConfig(**CHURN)
ix = make_index("deltatree", cfg=dataclasses.replace(
    pc.tree_config, collect_stats=True, collect_transfers=True))
sch = ServeScheduler(cfg, params, pc, SchedulerConfig(max_live=3), index=ix)
plans = synth_trace(10, seed=11, vocab=cfg.vocab_size, **TRACE)
sch.run_trace(plans[:6], drain=False)
sch.scan(list(range(sch._next_id)))
sch.run_trace(plans[6:])
rec["metrics"] = np.asarray(json.dumps(sch.metrics()))
rec["prom"] = np.asarray(sch.metrics("prometheus"))
'''

LATENCY = ("p50_us", "p99_us")


def _no_latency(snap: dict) -> dict:
    """A metrics snapshot without the wall-clock latency percentiles."""
    return {g: {k: v for k, v in d.items() if k not in LATENCY}
            for g, d in snap.items()}


def test_scheduler_metrics_equal_jax(tmp_path_factory, monkeypatch):
    """``metrics()`` over a pager whose index collects stats: the dict
    equals JAX's on the same smoke trace (serve, scan, maintenance, pager,
    search and transfers; a single tree has no router leg), the wall-clock
    latency percentiles aside, and the Prometheus and JSON forms render
    the same snapshot."""
    monkeypatch.delenv(trace.ENV, raising=False)
    trace.reset_counters()       # earlier tests in this worker may bump
    consts = dict(CHURN=CHURN, TRACE=TRACE)
    head = "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    rec = jax_npz(tmp_path_factory, "torch_obs_metrics",
                  head + SERVE_PRELUDE + _JAX_METRICS)
    from repro_torch.serve import SchedulerConfig, ServeScheduler, synth_trace
    from repro_torch.serving import PagerConfig

    model = serve_model(rec)
    cfg = model.cfg
    pc = PagerConfig(**CHURN, engine="lockstep")
    ix = make_index("deltatree", cfg=dataclasses.replace(
        pc.tree_config, collect_stats=True, collect_transfers=True),
        device="cpu")
    sch = ServeScheduler(cfg, model, pc, SchedulerConfig(max_live=3),
                         index=ix)
    plans = synth_trace(10, seed=11, vocab=cfg.vocab_size, **TRACE)
    sch.run_trace(plans[:6], drain=False)
    sch.scan(list(range(sch._next_id)))
    sch.run_trace(plans[6:])
    snap = sch.metrics()
    want = json.loads(str(rec["metrics"]))
    assert set(snap) == set(want) == {"serve", "scan", "maintenance",
                                      "pager", "search", "transfers"}
    assert _no_latency(snap) == _no_latency(want)
    assert json.loads(sch.metrics("json")) == snap
    prom = sch.metrics("prometheus")
    assert prom == export.to_prometheus(snap)
    keep = [ln for ln in prom.splitlines()
            if not any(k in ln for k in LATENCY)]
    assert keep == [ln for ln in str(rec["prom"]).splitlines()
                    if not any(k in ln for k in LATENCY)]
    with pytest.raises(ValueError, match="fmt"):
        sch.metrics("xml")
