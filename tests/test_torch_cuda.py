"""PyTorch port on a CUDA card (``requires_cuda``; skipped without one).

The CUDA kernels have no CPU mode, so these tests hold them (the walks and
the range scan), and the whole update and scan path on the card under eager
and deferred maintenance, against the port's plain versions on the CPU.
This file imports torch, numpy and the port only (the card's machine has
no jax); run it there with

    PYTHONPATH=src python -m pytest -m requires_cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.api import OpBatch, make_index
from repro_torch.core import deltatree as TDT
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import veb_search as TVS

WALK = ("leaf_val", "leaf_b", "final_dn", "hops", "cand")
ROWS = ("leaf_val", "leaf_b", "next_dn", "cand")
SCAN = ("out", "n", "hops", "more")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _equal(want, got, names, where):
    for name, a, b in zip(names, want, got):
        assert a.dtype == b.dtype, (where, name)
        assert torch.equal(a.cpu(), b.cpu()), (where, name)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("payload_bits", [0, 12])
def test_cuda_kernels_equal_plain(cuda, payload_bits):
    """Both CUDA kernels equal their plain versions exactly, sentinels and
    per-query roots included; `veb_walk_rows` in every round of the
    per-round walk, on the rows that walk gathers."""
    cfg = TDT.TreeConfig(height=7, max_dnodes=4096, buf_cap=16,
                         payload_bits=payload_bits, engine="lockstep")
    rng = np.random.default_rng(payload_bits)
    vals = np.unique(rng.integers(1, 200_000, 20_000))
    t = TDT.bulk_build(cfg, vals, vals % 4096 if payload_bits else None,
                       device=cuda)
    kinds = rng.choice([1, 2], 512).astype(np.int32)
    keys = rng.integers(1, 200_000, 512).astype(np.int32)
    t, _, _ = TDT.update_batch(cfg, t, kinds, keys)
    q = cfg.qpack(torch.as_tensor(rng.integers(1, 210_000, 4096)
                                  .astype(np.int32), device=cuda))
    q[:7] = TVS.walk_big(cfg.vdtype)
    alive = torch.nonzero(t.alive)[:, 0].to(torch.int32)
    roots = t.root.expand(q.shape[0]).clone()
    pick = rng.integers(0, alive.numel(), roots[::5].numel())
    roots[::5] = alive[torch.as_tensor(pick, device=cuda)]
    got = TVS.veb_walk_fused(t.value, t.child, roots, q, height=7,
                             max_rounds=cfg.walk_round_cap)
    want = TREF.ref_delta_walk_fused(t.value, t.child, roots, q, height=7,
                                     max_rounds=cfg.walk_round_cap)
    _equal(want, got, WALK, "fused")
    # replay of repro_torch.kernels.ops._delta_walk, checked per round
    dn = roots.clone()
    resolved = q == TVS.walk_big(cfg.vdtype)
    rounds = 0
    while not bool(resolved.all()):
        dnc = dn.long()
        rows, crows = t.value[dnc], t.child[dnc]
        got = TVS.veb_walk_rows(rows, crows, q, height=7)
        want = TREF.ref_veb_walk_rows(rows, crows, q, height=7)
        _equal(want, got, ROWS, ("rows", rounds))
        act = ~resolved
        dn = torch.where(act & (got[2] >= 0), got[2], dn)
        resolved = resolved | (act & (got[2] < 0))
        rounds += 1
        assert rounds <= cfg.walk_round_cap
    assert rounds > 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("walk_fused", [True, False])
def test_cuda_index_equals_cpu_index(cuda, walk_fused):
    """The main path on the card (kernels, scatters, index_add_, sorts)
    leaves every arena array equal to the same run on the CPU."""
    rng = np.random.default_rng(3)
    init = np.unique(rng.integers(1, 50_000, 5_000)).astype(np.int32)
    kw = dict(height=5, max_dnodes=2048, buf_cap=8, engine="lockstep",
              walk_fused=walk_fused)
    gix = make_index("deltatree", initial=init, device=cuda, **kw)
    cix = make_index("deltatree", initial=init, device="cpu", **kw)
    launches = TVS.veb_walk_fused.launches + TVS.veb_walk_rows.launches
    for step in range(6):
        kinds = rng.choice([0, 1, 1, 2], 512).astype(np.int32)
        keys = rng.integers(1, 52_000, 512).astype(np.int32)
        _equal(cix.search(keys), gix.search(keys), ("found", "hops"), step)
        batch = OpBatch.mixed(kinds, keys)
        gix, gres, gst = gix.update(batch)
        cix, cres, cst = cix.update(batch)
        assert torch.equal(gres.cpu(), cres) and gst == cst, step
        for name, a, b in zip(TDT.DeltaTree._fields, cix.state, gix.state):
            assert torch.equal(a, b.cpu()), (step, name)
    q = rng.integers(0, 53_000, 256).astype(np.int32)
    _equal(cix.successor(q), gix.successor(q), ("found", "succ"), "succ")
    assert TVS.veb_walk_fused.launches + TVS.veb_walk_rows.launches > launches


@pytest.mark.requires_cuda
@pytest.mark.parametrize("payload_bits", [0, 12])
def test_cuda_scan_kernel_equals_plain(cuda, payload_bits):
    """`veb_scan_fused` equals its plain version exactly: sparse, dense,
    empty and past-the-end bands, sentinel lanes, per-lane roots, rows
    that fill, and a round cap that truncates."""
    from repro_torch.kernels import ops as TOPS

    cfg = TDT.TreeConfig(height=7, max_dnodes=4096, buf_cap=16,
                         payload_bits=payload_bits, engine="lockstep")
    rng = np.random.default_rng(10 + payload_bits)
    vals = np.unique(rng.integers(1, 200_000, 20_000))
    t = TDT.bulk_build(cfg, vals, vals % 4096 if payload_bits else None,
                       device=cuda)
    for _ in range(2):
        kinds = rng.choice([1, 2, 2], 1024).astype(np.int32)
        keys = rng.choice(vals, 1024).astype(np.int32)
        kinds[::3] = 1
        keys[::3] = rng.integers(1, 200_000, keys[::3].size)
        t, _, _ = TDT.update_batch(cfg, t, kinds, keys)
    k = 2048
    st = rng.integers(0, 210_000, k).astype(np.int32)
    width = np.where(rng.random(k) < 0.5, rng.integers(1, 200, k),
                     rng.integers(1_000, 400_000, k))
    hi = np.minimum(st + width, 2**31 - 2).astype(np.int32)
    hi[:64] = st[:64] - rng.integers(0, 100, 64)
    sp = cfg.qpack(torch.as_tensor(st, device=cuda))
    hp = cfg.qpack(torch.as_tensor(hi, device=cuda))
    sp[64:80] = TVS.walk_big(cfg.vdtype)
    alive = torch.nonzero(t.alive)[:, 0].to(torch.int32)
    roots = t.root.expand(k).clone()
    pick = rng.integers(0, alive.numel(), roots[::7].numel())
    roots[::7] = alive[torch.as_tensor(pick, device=cuda)]
    for max_out, cap in ((16, None), (128, None), (128, 200)):
        truncating = cap is not None
        cap = cap or TOPS.scan_round_cap(7, cfg.max_dnodes, max_out)
        args = (t.value, t.mark, t.child, roots, sp, hp)
        kw = dict(height=7, max_out=max_out, pmask=cfg.pmask, max_rounds=cap)
        got = TVS.veb_scan_fused(*args, **kw)
        want = TREF.ref_delta_scan_fused(*args, **kw)
        _equal(want, got, SCAN, (max_out, cap))
        assert (got[1] > 0).any()
        assert bool((got[2] == cap).any()) if truncating else got[3].any()


@pytest.mark.requires_cuda
def test_cuda_deferred_index_equals_cpu_index(cuda):
    """Deferred maintenance and range scans on the card: every arena
    array, update result and stat, and every scan and successor batch
    equal the same run on the CPU; the scans launch the scan kernel."""
    rng = np.random.default_rng(4)
    init = np.unique(rng.integers(1, 50_000, 5_000)).astype(np.int32)
    kw = dict(height=5, max_dnodes=2048, buf_cap=8, engine="lockstep",
              maintenance="deferred")
    gix = make_index("deltatree", initial=init, device=cuda, **kw)
    cix = make_index("deltatree", initial=init, device="cpu", **kw)
    launches = TVS.veb_scan_fused.launches
    pending = 0
    for step in range(4):
        kinds = rng.choice([0, 1, 1, 2], 512).astype(np.int32)
        keys = rng.integers(1, 52_000, 512).astype(np.int32)
        batch = OpBatch.mixed(kinds, keys)
        gix, gres, gst = gix.update(batch)
        cix, cres, cst = cix.update(batch)
        assert torch.equal(gres.cpu(), cres) and gst == cst, step
        pending = max(pending, cst.pending)
        for name, a, b in zip(TDT.DeltaTree._fields, cix.state, gix.state):
            assert torch.equal(a, b.cpu()), (step, name)
        lo = rng.integers(0, 52_000, 256).astype(np.int32)
        hi = (lo + rng.integers(1, 2_000, 256)).astype(np.int32)
        _equal(cix.spec.backend.scan(cix.cfg, cix.state, lo, hi, 32),
               gix.spec.backend.scan(gix.cfg, gix.state, lo, hi, 32),
               ("keys", "payloads", "n", "hops", "more"), step)
        _equal(cix.successor(keys), gix.successor(keys), ("found", "succ"),
               step)
    assert pending > 0
    assert TVS.veb_scan_fused.launches == launches + 4
