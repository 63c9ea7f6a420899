"""One run of one cell: set-up, the window, the comparison, the result.

Set-up builds the index from the seed's data, draws the traffic, and runs
the mix's warm-up steps through the same client (they touch every shape
the window uses; their updates are part of the stream the reference
replays).  With ``trace``, spans are on for the whole window
(``REPRO_TRACE=1``) and ``torch.profiler`` records its last second.
"""

from __future__ import annotations

import gc
import os
import sys
import time

import numpy as np
import torch

from portbench.bench import cells, check, client as C, data, devtrace, system
from portbench.bench import traffic as T

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the profiled stretch at the window's end (at least three steps): the
# profiler's records of a longer one take more set-up than they add
TRACE_SECONDS = 1.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, whole)
    is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def live_arrays(ix):
    items = ix.live_items()
    a = np.asarray(items, dtype=np.int64).reshape(-1, 2)
    return a[:, 0].copy(), a[:, 1].copy()


def sample_offsets(seed: int, count: int, seconds: float) -> list:
    """The window's start and ``count`` offsets drawn from the seed: the
    read answers of the first step to start at or after each are kept."""
    rng = np.random.default_rng([seed, 2])
    return [0.0] + sorted((rng.random(count) * seconds).tolist())


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", bench=None, root=cells.ROOT, config_over=None,
             traffic_over=None, wrap=None, replace=None, t0=None,
             log=None) -> dict:
    """Runs the cell once; returns the result line's object (and on
    stderr, through ``log``, the numbers compared beside their limits).
    ``wrap(ix, ds)`` wraps the built index (the tests' faults);
    ``replace(ds)`` stands in for it, unbuilt (the control)."""
    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    bench = bench or cells.load_bench(root)
    cell = cells.by_name(bench["workloads"], cell_name, "workload")
    config = _merge(cells.load_config(bench, cell["config"], root),
                    config_over)
    traffic = _merge(cells.load_traffic(cell["traffic"], root), traffic_over)
    entries = cells.metrics_for(bench, cell_name, trace)
    readers = {m["name"]: cells.metric_module(m["name"], root)
               for m in entries}
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    marks = [("start", t0), ("imports", time.perf_counter())]
    ds = data.make(config, np.random.default_rng([seed, 0]),
                   T.fresh_needed(traffic))
    marks.append(("data", time.perf_counter()))
    stream = T.make(traffic, ds, np.random.default_rng([seed, 1]), dev)
    marks.append(("traffic", time.perf_counter()))
    if replace is not None:
        ix = replace(ds)
    else:
        ix = system.build(config, ds, dev)
        if wrap is not None:
            ix = wrap(ix, ds)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("build", time.perf_counter()))
    keep = traffic["keep_reads"]
    cl = C.Client(ix, stream, dev, keep,
                  [] if keep == "all" else
                  sample_offsets(seed, int(keep), seconds))
    cl.run_warmup()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # set-up's objects leave the collector's generations, so the window's
    # collections do not walk them again
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    marks.append(("warm-up", time.perf_counter()))
    log("set-up: " + ", ".join(f"{n} {b - a:.3f} s" for (_, a), (n, b)
                               in zip(marks, marks[1:])))

    prof, pre = None, {}
    if trace:
        from repro_torch.obs import trace as OT

        os.environ[OT.ENV] = "1"
        OT.reset_events()
        OT.reset_counters()
        z = torch.zeros((), dtype=torch.int64, device=dev)
        cl.hops, cl.count_hops = [z, z.clone()], True

        def on_trace_start(i):
            nonlocal prof
            pre["events"] = OT.events()
            pre["step"] = i
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts, acc_events=True)
            prof.__enter__()

        win = cl.window(seconds, max(seconds - TRACE_SECONDS, 0.0),
                        on_trace_start, TRACE_SECONDS)
        if cuda:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.environ[OT.ENV] = "0"
    else:
        win = cl.window(seconds)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    steps = cl.steps.arrays()
    first, end = win["first"], win["end"]
    run = Run(cell=cell, config=config, traffic=traffic, stream=stream,
              setup_s=setup_s, window_s=win["window_s"], first=first,
              end=end, steps=steps, trace=trace, captures={})
    if trace:
        d, h = devtrace.split_events(prof)
        del prof
        stepped = [e for e in h if e[2] == "client.step"]
        lo, hi = stepped[0][0], stepped[-1][1]
        busy = devtrace.busy_intervals(d, lo, hi)
        run.__dict__.update(
            dev_events=d, host_events=h, slice_lo=lo, slice_hi=hi,
            profiled_steps=len(stepped), traced_from=pre["step"],
            spans=pre["events"],
            busy_s=sum(e - s for s, e in busy) / 1e6,
            slice_s=(hi - lo) / 1e6,
            hops_mean=(float(cl.hops[0]) / float(cl.hops[1])
                       if float(cl.hops[1]) else None),
            breakdown=devtrace.breakdown(d, h, lo, hi))
        ctx = Run(ix=cl.ix, stream=stream, device=dev, run_config=config,
                  last_step=end - 1)
        for name, mod in readers.items():
            if hasattr(mod, "capture"):
                run.captures[name] = mod.capture(ctx)
    if cl.ix.alloc_failed():
        raise RuntimeError("the index's arena is full: its configuration "
                           "provisions too few ΔNodes for this window")

    live = live_arrays(cl.ix)
    cl.ix = ix = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    cmp = check.compare(config, ds, stream, cl, end, live, dev)
    t_check = time.perf_counter() - t_check
    checks = {k: {"value": cmp[k], "limit": lim}
              for k, lim in check.LIMITS.items()}
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and cmp["reads_compared"] > 0)

    metrics = {}
    for m in entries:
        v = readers[m["name"]].read(run, m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    win_ops = steps["n_reads"][first:end].sum() + \
        steps["n_writes"][first:end].sum()
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct), "attempted": int(win_ops),
           "failed": int(cmp["read_wrong"] + cmp["update_wrong"]),
           "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = run.busy_s
        device_info["window_s"] = run.slice_s
        out["breakdown"] = run.breakdown
    log(f"window: {end - first} steps, {int(win_ops)} ops in "
        f"{win['window_s']:.6f} s; set-up {setup_s:.6f} s; compared "
        f"{cmp['reads_compared']} read answers, {cmp['updates_compared']} "
        f"update results and the live set of {live[0].size} keys in "
        f"{t_check:.3f} s")
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: "
                         f"{bad}")
    for k, c in checks.items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    out["checks"] = checks
    return out
