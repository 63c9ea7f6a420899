"""The readers of the update path's spans and counters, and of the runtime
calls inside the spans, on made-up runs: a host trace with known
containment, a ring and counters, and the cases that read nothing."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.bench import cells, spanwalk as W
from portbench.bench.runner import Run

# (start_us, end_us, name), sorted by start: two steps, each a read call
# (an engine span with launches, one launch outside it) and an update
# call (syncs inside maint.batch, one sync outside it); a third step
# runs past the profiled stretch's end
HOST = sorted([
    (0, 100, "client.step"),
    (1, 40, "client.read"),
    (2, 30, "engine.lockstep.lookup"),
    (3, 4, "cudaLaunchKernel"),
    (5, 6, "cudaLaunchKernelExC_v11060"),
    (7, 8, "cuLaunchKernel"),
    (9, 10, "cudaMemcpyAsync"),
    (31, 32, "cudaLaunchKernel"),         # in the read, not the engine
    (41, 42, "cudaStreamSynchronize"),    # between the calls
    (45, 95, "client.update"),
    (46, 94, "maint.batch"),
    (47, 60, "maint.sweep"),
    (48, 59, "maint.expand"),
    (49, 50, "cudaMemcpyAsync"),
    (50, 51, "cudaStreamSynchronize"),
    (52, 53, "cudaMemcpy"),
    (61, 62, "cudaEventSynchronize"),
    (63, 64, "cudaDeviceSynchronize"),
    (65, 66, "cudaLaunchKernel"),
    (100, 200, "client.step"),
    (101, 140, "client.read"),
    (102, 130, "engine.lockstep.scan"),
    (103, 104, "cudaLaunchKernel"),
    (146, 194, "maint.batch"),
    (150, 151, "cudaStreamSynchronize"),
    (200, 300, "client.step"),
    (201, 240, "client.read"),
    (202, 230, "engine.lockstep.lookup"),
    (203, 204, "cudaLaunchKernel"),
    (246, 310, "maint.batch"),            # ends past the stretch
    (250, 251, "cudaStreamSynchronize"),
])
DEV = [(3.5, 3.9, "walk_fused_kernel")]


def reader(name):
    return cells.metric_module(name)


def traced_run(**kw):
    base = dict(dev_events=DEV, host_events=HOST, slice_lo=0.0,
                slice_hi=300.0, first=3, end=8, traced_from=6, trace=True,
                spans=[], steps={"n_writes": np.asarray([2.0] * 8)})
    base.update(kw)
    return Run(**base)


def test_span_walk_containment():
    batches = W.ranges(HOST, "maint.batch".__eq__, 0, 300)
    assert batches == [(46, 94, "maint.batch"), (146, 194, "maint.batch")]
    got = W.inside(HOST, lambda n: n.startswith("cuda"), batches[:1])
    assert [e[2] for e in got] == [
        "cudaMemcpyAsync", "cudaStreamSynchronize", "cudaMemcpy",
        "cudaEventSynchronize", "cudaDeviceSynchronize", "cudaLaunchKernel"]
    assert W.inside(HOST, "cudaMemcpy".__eq__, []) == []
    # an event that starts inside a range but ends past it is outside;
    # ranges that overlap, in any order, count as their union
    x = "x".__eq__
    assert W.inside([(5, 12, "x")], x, [(0, 10, "r")]) == []
    outer = [(9, 14, "r"), (0, 10, "r")]
    assert W.inside([(5, 12, "x"), (13, 15, "x")], x, outer) == [
        (5, 12, "x")]


def test_syncs_per_update():
    # 4 waits in the first call, 1 in the second; the third lies past the
    # stretch and the sync between the calls is in none
    assert reader("maint.syncs_per_update").read(traced_run(), "") == 2.5


def test_launches_per_read():
    # 3 + 1 + 1 launches inside engine spans over 3 read calls; the launch
    # in the first read but outside its engine span does not count
    assert reader("engine.launches_per_read").read(
        traced_run(), "") == pytest.approx(5 / 3)


@pytest.mark.parametrize("name", ["maint.syncs_per_update",
                                  "engine.launches_per_read"])
def test_device_trace_readers_read_nothing(name):
    r = reader(name)
    assert r.read(traced_run(dev_events=[]), name) is None
    # a program without the spans (the parent's maint.batch, say)
    bare = [e for e in HOST if e[2] not in ("maint.batch", "client.read")]
    assert r.read(traced_run(host_events=bare), name) is None


def _ring(*names_durs):
    return [{"name": n, "ph": "X", "ts": 0.0, "dur": d} for n, d in names_durs]


def test_repair_ms(monkeypatch):
    from repro_torch.obs import trace

    r = reader("maint.repair_ms")
    ring = _ring(("maint.batch", 900.0), ("maint.sweep", 700.0),
                 ("maint.rebalance", 100.0), ("maint.expand", 250.0),
                 ("maint.merge", 50.0), ("maint.ops", 150.0))
    monkeypatch.setattr(trace, "counters", lambda: {"maint.batch": 3})
    # 400 µs of repairs over the 3 update calls before the profiled stretch
    assert r.read(traced_run(spans=ring), "") == pytest.approx(0.4 / 3)
    no_writes = {"n_writes": np.zeros(8)}
    assert r.read(traced_run(spans=ring, steps=no_writes), "") is None
    assert r.read(traced_run(spans=ring[1:]), "") is None
    monkeypatch.setattr(trace, "counters",
                        lambda: {"maint.batch": 3, "trace.events_dropped": 1})
    assert r.read(traced_run(spans=ring), "") is None


def test_seq_ops_per_kop(monkeypatch):
    from repro_torch.obs import trace

    r = reader("maint.seq_ops_per_kop")
    monkeypatch.setattr(trace, "counters",
                        lambda: {"maint.batch": 5, "maint.seq_ops": 3})
    # 3 ops one by one among the window's 10 update ops
    assert r.read(traced_run(), "") == pytest.approx(300.0)
    monkeypatch.setattr(trace, "counters", lambda: {"maint.batch": 5})
    assert r.read(traced_run(), "") == 0.0
    monkeypatch.setattr(trace, "counters", lambda: {"maint.seq_ops": 3})
    assert r.read(traced_run(), "") is None
