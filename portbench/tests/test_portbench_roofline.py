"""The frozen roofline arithmetic against the functions of
``chip_smoke.py`` it was copied from, on a small churned tree, and the
device-time arithmetic on a made-up trace."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import chip_smoke as CS
from portbench.bench import devtrace, roofline as R


@pytest.fixture(scope="module", params=[0, 12], ids=["set", "map"])
def tree(request):
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(1, CS.KEY_MAX, 6000).astype(np.int32))
    cfg, t = CS.churned_tree(keys, request.param, rng, "cpu")
    return cfg, t, keys, rng


def test_fused_needs_equal(tree):
    cfg, t, keys, rng = tree
    q = CS.kernel_queries(cfg, t, keys, 3000, rng, "cpu")
    roots = torch.full((q.numel(),), int(t.root), dtype=torch.int32)
    want_b, _ = CS.fused_needs(t, cfg.height, q, roots, 64)
    got_b = R.fused_needs(t, cfg.height, q, roots, 64)
    assert got_b == want_b
    assert R.bound_ms(got_b) == CS.bound_ms(want_b)


def test_scan_needs_equal(tree):
    cfg, t, keys, rng = tree
    starts, his = CS.scan_bands(rng, keys.size, 500, "dense", 16)
    sp, hp = CS.pack_bands(cfg, starts, his, "cpu")
    roots = torch.full((sp.numel(),), int(t.root), dtype=torch.int32)
    args = (t, cfg.height, roots, sp, hp, 16, int(cfg.pmask), 4096)
    assert R.scan_needs(*args) == CS.scan_needs(*args)[0]


@pytest.mark.parametrize("height", [3, 7, 12, 13, 16])
def test_pos_table_and_bytes_equal(height):
    from repro_torch.kernels.ref import pos_table

    assert torch.equal(R.pos_table(height, "cpu"), pos_table(height, "cpu"))
    nodes = [torch.arange(1, 2 ** min(height, 9)), torch.tensor([1, 3, 5])]
    assert R.pos_bytes(height, nodes) == CS.pos_bytes(height, nodes)


def _event(dev: bool, name: str, s: float, e: float):
    kind = (torch.autograd.DeviceType.CUDA if dev
            else torch.autograd.DeviceType.CPU)
    return types.SimpleNamespace(
        device_type=kind, name=name,
        time_range=types.SimpleNamespace(start=s, end=e,
                                         elapsed_us=lambda: e - s))


def test_busy_union_and_idle_gaps():
    evs = [_event(True, "void walk_fused_kernel<int>", 0, 40),
           _event(True, "client.step", 0, 100),     # the span's mirror
           _event(True, "paged_decode_split_kernel", 30, 50),
           _event(True, "nvjet_gemm", 60, 70),
           _event(False, "client.step", 0, 100),
           _event(False, "aten::item", 52, 58)]
    prof = types.SimpleNamespace(events=lambda: evs)
    dev, host = devtrace.split_events(prof)
    assert [d[2] for d in dev] == ["void walk_fused_kernel<int>",
                                   "paged_decode_split_kernel", "nvjet_gemm"]
    busy = devtrace.busy_intervals(dev, 0, 100)
    assert busy == [[0, 50], [60, 70]]          # the overlap counted once
    gaps = devtrace.idle_gaps(busy, 0, 100)
    assert gaps == [(50, 60), (70, 100)]
    b = devtrace.breakdown(dev, host, 0, 100)
    assert b["idle_gaps"][0] == ["client.step", 30e-6]
    assert dict(b["idle_gaps"])["client.step > aten::item"] == 10e-6


def test_kernel_share_counts_only_the_reads_launches():
    """A step's update launches the walk too (the scheduler's position
    walks): the share times only the launch inside the read's spans."""
    host = [(0, 100, "client.step"), (0, 30, "client.read"),
            (30, 50, "client.read_copy"), (50, 100, "client.update")]
    dev = [(10, 20, "walk_fused_kernel<int, 64, false>"),
           (60, 99, "walk_fused_kernel<int, 64, false>")]
    run = types.SimpleNamespace(host_events=host, dev_events=dev,
                                slice_lo=0, slice_hi=100)
    nbytes = int(R.HBM_BYTES_PER_S * 1e-6)      # one microsecond's bytes
    share = R.kernel_share(run, nbytes, "walk_fused_kernel")
    assert share == pytest.approx(100.0 / 10)
