"""The client: one closed loop that drives the index step after step.

A step is one read call, its answers copied into pinned host memory and
waited for, then (where the mix has updates) one update call, its results
copied and waited for.  On the card each step's latencies are read from
CUDA events on the stream (the device's clock): from the step's start
to the moment its read answers, or its update results, are on the host.
The window's length and its rate are read from the host's clock, over
the whole window.

The answers of every update, and the read answers of a sample of steps
drawn from the seed (of every step where they are small), stay in the
pinned buffers for the comparison after the window.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.bench import system

# steps run before the window: the first builds every kernel the mix's
# calls launch and sizes the answer buffers; the rest warm the allocator
WARMUP_STEPS = 3


@dataclasses.dataclass
class Steps:
    """Per-step records of the steps run (warm-up included)."""

    read_ms: list = dataclasses.field(default_factory=list)
    write_ms: list = dataclasses.field(default_factory=list)
    n_reads: list = dataclasses.field(default_factory=list)
    n_writes: list = dataclasses.field(default_factory=list)
    repairs: list = dataclasses.field(default_factory=list)

    def arrays(self) -> dict:
        return {k: np.asarray(v, dtype=np.float64)
                for k, v in dataclasses.asdict(self).items()}


class Clock:
    """Step latencies: CUDA events on the card, the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def start(self):
        if self.cuda:
            self.ev[0].record()
        else:
            self.t0 = time.perf_counter()

    def lap(self, j: int) -> float:
        """Waits for the work queued so far; ms since `start`."""
        if self.cuda:
            self.ev[j].record()
            self.ev[j].synchronize()
            return self.ev[0].elapsed_time(self.ev[j])
        return (time.perf_counter() - self.t0) * 1e3


class Client:
    def __init__(self, ix, stream, device, keep_reads, sample_at):
        """``keep_reads``: "all", or keep the read answers of the first
        step to start at or after each offset in ``sample_at`` (seconds
        into the window, ascending)."""
        self.ix, self.stream, self.device = ix, stream, torch.device(device)
        self.read = system.read_call(stream.read_op, stream.k)
        self.clock = Clock(device)
        self.steps = Steps()
        self.keep_all = keep_reads == "all"
        self.sample_at = list(sample_at)
        self.kept: dict[int, int] = {}       # step -> buffer row
        self.hops = None                     # (sum, count) on the device
        self.count_hops = False
        pin = self.device.type == "cuda"
        # the first warm-up step's answers give the buffers their shapes
        outs, _ = self.read(self.ix, stream.reads(0))
        rows = (stream.max_steps if self.keep_all else len(self.sample_at) + 1)
        self.read_bufs = [torch.empty((rows, *o.shape), dtype=o.dtype,
                                      pin_memory=pin) for o in outs]
        self.scratch = rows - 1
        self.res_buf = None
        if stream.update_kind is not None:
            u = stream.upd_kinds.shape[1]
            self.res_buf = torch.empty((stream.max_steps, u),
                                       dtype=torch.bool, pin_memory=pin)

    def step(self, i: int, row: int) -> None:
        s = self.stream
        with record_function("client.step"):
            self.clock.start()
            with record_function("client.read"):
                outs, hops = self.read(self.ix, s.reads(i))
                if self.count_hops:
                    self.hops[0] += hops.sum()
                    self.hops[1] += hops.numel()
            with record_function("client.read_copy"):
                for buf, o in zip(self.read_bufs, outs):
                    buf[row].copy_(o, non_blocking=True)
                self.steps.read_ms.append(self.clock.lap(1))
            upd = s.updates(i)
            nr, nw = s.ops(i)
            self.steps.n_reads.append(nr)
            self.steps.n_writes.append(nw)
            if upd is None:
                self.steps.write_ms.append(np.nan)
                self.steps.repairs.append(0)
                return
            with record_function("client.update"):
                self.ix, res, stats = system.update_call(self.ix, *upd)
            with record_function("client.update_copy"):
                self.res_buf[i].copy_(res, non_blocking=True)
                self.steps.write_ms.append(self.clock.lap(2))
            self.steps.repairs.append(
                0 if stats is None
                else stats.rebuilds + stats.expands + stats.merges)

    def row_for(self, i: int, offset: float | None) -> int:
        """The buffer row step ``i`` writes its read answers into."""
        if self.keep_all:
            return i
        if offset is not None and self.sample_at and \
                offset >= self.sample_at[0]:
            while self.sample_at and offset >= self.sample_at[0]:
                self.sample_at.pop(0)
            row = len(self.kept)
            self.kept[i] = row
            return row
        return self.scratch

    def run_warmup(self) -> None:
        for i in range(WARMUP_STEPS):
            self.step(i, self.row_for(i, None))

    def window(self, seconds: float, trace_from: float | None = None,
               on_trace_start=None, trace_for: float = 0.0,
               min_traced: int = 3) -> dict:
        """Steps until ``seconds`` have passed; the host-clock window.
        With ``trace_from``, ``on_trace_start(i)`` is called before the
        first step that starts at or after that offset, and the window
        runs on until ``trace_for`` seconds and ``min_traced`` steps have
        passed since it returned."""
        i = WARMUP_STEPS
        t0 = time.perf_counter()
        end = t0 + seconds
        traced_from = traced_at = None
        while True:
            now = time.perf_counter()
            if now >= end and (traced_from is None or (
                    i - traced_from >= min_traced
                    and now - traced_at >= trace_for)):
                break
            if trace_from is not None and traced_from is None and \
                    now - t0 >= trace_from:
                on_trace_start(i)
                traced_from, traced_at = i, time.perf_counter()
            self.step(i, self.row_for(i, now - t0))
            i += 1
        return {"first": WARMUP_STEPS, "end": i,
                "window_s": time.perf_counter() - t0,
                "traced_from": traced_from}

    def read_answers(self, i: int):
        """The host copies of step ``i``'s read answers, or None."""
        row = i if self.keep_all else self.kept.get(i)
        if row is None or (self.keep_all and i >= self.read_bufs[0].shape[0]):
            return None
        return [b[row] for b in self.read_bufs]

    def update_results(self, i: int):
        return None if self.res_buf is None else self.res_buf[i]
