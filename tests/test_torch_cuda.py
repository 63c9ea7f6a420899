"""PyTorch port on a CUDA card (``requires_cuda``; skipped without one).

The CUDA kernels have no CPU mode, so these tests hold them, and the whole
update path on the card, against the port's plain versions on the CPU.
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
