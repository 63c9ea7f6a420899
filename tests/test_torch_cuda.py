"""PyTorch port on a CUDA card (``requires_cuda``; skipped without one).

The CUDA kernels have no CPU mode, so these tests hold them (the walks, the
range scan and the paged decode attention), the whole update and scan path
on the card under eager and deferred maintenance, the serve path, the
comparison structures and the read statistics against the port's plain
versions on the CPU.
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
@pytest.mark.parametrize("height", [3, 4, 5, 7, 8, 12])
def test_cuda_kernels_equal_plain(cuda, height, payload_bits):
    """Both CUDA kernels equal their plain versions exactly, sentinels and
    per-query roots included, at heights whose paths cross 1, 2 and 4 vEB
    pieces; the fused kernel also on batches that leave a block part-full
    (K = 1, 31, 33, 1000); `veb_walk_rows` in every round of the
    per-round walk, on the rows that walk gathers."""
    n_keys = 20_000
    cfg = TDT.TreeConfig(height=height, buf_cap=16,
                         max_dnodes=max(256, 6 * n_keys // 2 ** (height - 1)),
                         payload_bits=payload_bits, engine="lockstep")
    rng = np.random.default_rng(payload_bits)
    vals = np.unique(rng.integers(1, 200_000, n_keys))
    t = TDT.bulk_build(cfg, vals, vals % 4096 if payload_bits else None,
                       device=cuda)
    kinds = rng.choice([1, 2], 512).astype(np.int32)
    keys = rng.integers(1, 200_000, 512).astype(np.int32)
    t, _, _ = TDT.update_batch(cfg, t, kinds, keys)
    assert not bool(t.alloc_fail)
    q = cfg.qpack(torch.as_tensor(rng.integers(1, 210_000, 4096)
                                  .astype(np.int32), device=cuda))
    q[:7] = TVS.walk_big(cfg.vdtype)
    alive = torch.nonzero(t.alive)[:, 0].to(torch.int32)
    roots = t.root.expand(q.shape[0]).clone()
    pick = rng.integers(0, alive.numel(), roots[::5].numel())
    roots[::5] = alive[torch.as_tensor(pick, device=cuda)]
    cap = cfg.walk_round_cap
    for k in (1, 31, 33, 1000, 4096):
        args = (t.value, t.child, roots[:k].contiguous(), q[:k].contiguous())
        got = TVS.veb_walk_fused(*args, height=height, max_rounds=cap)
        want = TREF.ref_delta_walk_fused(*args, height=height, max_rounds=cap)
        _equal(want, got, WALK, ("fused", k))
    # replay of repro_torch.kernels.ops._delta_walk, checked per round
    dn = roots.clone()
    resolved = q == TVS.walk_big(cfg.vdtype)
    rounds = 0
    while not bool(resolved.all()):
        dnc = dn.long()
        rows, crows = t.value[dnc], t.child[dnc]
        got = TVS.veb_walk_rows(rows, crows, q, height=height)
        want = TREF.ref_veb_walk_rows(rows, crows, q, height=height)
        _equal(want, got, ROWS, ("rows", rounds))
        act = ~resolved
        dn = torch.where(act & (got[2] >= 0), got[2], dn)
        resolved = resolved | (act & (got[2] < 0))
        rounds += 1
        assert rounds <= cap
    assert rounds > 1


def _churned(cuda, height, payload_bits, n_keys, key_hi, max_dnodes, seed):
    cfg = TDT.TreeConfig(height=height, buf_cap=16, max_dnodes=max_dnodes,
                         payload_bits=payload_bits, engine="lockstep")
    rng = np.random.default_rng(seed)
    vals = np.unique(rng.integers(1, key_hi, n_keys))
    t = TDT.bulk_build(cfg, vals, vals % 4096 if payload_bits else None,
                       device=cuda)
    kinds = rng.choice([1, 2], 512).astype(np.int32)
    keys = rng.integers(1, key_hi, 512).astype(np.int32)
    t, _, _ = TDT.update_batch(cfg, t, kinds, keys, keys % 4096)
    assert not bool(t.alloc_fail) and int(t.alive.sum()) > 1
    q = cfg.qpack(torch.as_tensor(rng.integers(1, key_hi + 10_000, 4096)
                                  .astype(np.int32), device=cuda))
    q[:7] = TVS.walk_big(cfg.vdtype)
    alive = torch.nonzero(t.alive)[:, 0].to(torch.int32)
    roots = t.root.expand(q.shape[0]).clone()
    pick = rng.integers(0, alive.numel(), roots[::5].numel())
    roots[::5] = alive[torch.as_tensor(pick, device=cuda)]
    return cfg, t, roots, q


@pytest.mark.requires_cuda
@pytest.mark.parametrize("block", [32, 64, 128, 256])
def test_cuda_walk_block_sizes_equal_plain(cuda, block):
    """Kernels 1 and 2 at each built block size (``q_tile``) equal their
    plain versions exactly at heights 5 and 12 (2 and 4 vEB pieces), set
    and map mode, with per-query roots (a block's lanes need not share the
    root it stages) and part-full blocks; an unbuilt size raises."""
    for height in (5, 12):
        for payload_bits in (0, 12):
            cfg, t, roots, q = _churned(
                cuda, height, payload_bits, 20_000, 200_000,
                max(256, 6 * 20_000 // 2 ** (height - 1)), height + block)
            cap = cfg.walk_round_cap
            for k in (1, block - 1, block + 1, 4096):
                args = (t.value, t.child, roots[:k].contiguous(),
                        q[:k].contiguous())
                got = TVS.veb_walk_fused(*args, height=height, max_rounds=cap,
                                         q_tile=block)
                want = TREF.ref_delta_walk_fused(*args, height=height,
                                                 max_rounds=cap)
                _equal(want, got, WALK, ("fused", height, k))
            dnc = roots.long()
            rows, crows = t.value[dnc], t.child[dnc]
            got = TVS.veb_walk_rows(rows, crows, q, height=height,
                                    q_tile=block)
            want = TREF.ref_veb_walk_rows(rows, crows, q, height=height)
            _equal(want, got, ROWS, ("rows", height))
    with pytest.raises(ValueError, match="block size"):
        TVS.veb_walk_rows(rows, crows, q, height=12, q_tile=block + 1)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("payload_bits", [0, 12])
@pytest.mark.parametrize("height", [13, 16, 22])
def test_cuda_tall_kernels_equal_plain(cuda, height, payload_bits):
    """Kernels 1-3 above height 12 (the position table in global memory;
    the fused walk stages the root at 13, where it fits, and not at 16 or
    22) equal their plain versions exactly on churned trees
    of several ΔNodes: the fused walk, the rows walk over each lane's
    first ΔNode (64 lanes at height 22: a row is 2**22 slots), and the
    scan at a full cap and at one that cuts lanes."""
    from repro_torch.kernels import ops as TOPS

    n_keys, max_dnodes = {13: (20_000, 64), 16: (40_000, 16),
                          22: (1_500_000, 8)}[height]
    cfg, t, roots, q = _churned(cuda, height, payload_bits, n_keys, 5_000_000,
                                max_dnodes, height)
    cap = cfg.walk_round_cap
    got = TVS.veb_walk_fused(t.value, t.child, roots, q, height=height,
                             max_rounds=cap)
    want = TREF.ref_delta_walk_fused(t.value, t.child, roots, q,
                                     height=height, max_rounds=cap)
    _equal(want, got, WALK, ("fused", height))
    assert int(got[3].max()) >= 2
    k = 64 if height > 16 else 1024
    dnc = roots[:k].long()
    rows, crows = t.value[dnc], t.child[dnc]
    got = TVS.veb_walk_rows(rows, crows, q[:k].contiguous(), height=height)
    want = TREF.ref_veb_walk_rows(rows, crows, q[:k].contiguous(),
                                  height=height)
    _equal(want, got, ROWS, ("rows", height))
    rng = np.random.default_rng(height)
    st = rng.integers(0, 5_000_000, 512).astype(np.int32)
    hi = (st + rng.integers(1, 50_000, 512)).astype(np.int32)
    sp = cfg.qpack(torch.as_tensor(st, device=cuda)).contiguous()
    hp = cfg.qpack(torch.as_tensor(hi, device=cuda)).contiguous()
    sr = roots[:512].contiguous()
    for max_rounds in (TOPS.scan_round_cap(height, max_dnodes, 32),
                       41):
        args = (t.value, t.mark, t.child, sr, sp, hp)
        kw = dict(height=height, max_out=32, pmask=cfg.pmask,
                  max_rounds=max_rounds)
        _equal(TREF.ref_delta_scan_fused(*args, **kw),
               TVS.veb_scan_fused(*args, **kw), SCAN, ("scan", max_rounds))


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
    that fill, and round caps of both parities that truncate (a cap cuts
    lanes inside VERIFY and inside FIND passes)."""
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
    for max_out, cap in ((16, None), (128, None), (128, 199), (128, 200),
                         (128, 201)):
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
@pytest.mark.parametrize("payload_bits", [0, 12])
def test_cuda_scan_kernel_deep_paths(cuda, payload_bits):
    """Paths deeper than the kernel's path stack (32 ΔNodes): the height-3
    tree of ascending inserts and deletes (`_torch_parity.deep_tree`),
    built on the CPU and moved to the card; the kernel equals its plain
    version at the full cap and at caps that cut lanes below the stack."""
    from _torch_parity import deep_tree
    from repro_torch.core.layout import KEY_MAX

    cfg, t = deep_tree(payload_bits)
    t = TDT.from_numpy(cfg, TDT.to_numpy(t), cuda)
    rng = np.random.default_rng(payload_bits)
    k = 64
    st = rng.integers(560, 600, k).astype(np.int32)
    hi = (st + rng.integers(5, 80, k)).astype(np.int32)
    st[0], hi[0] = 0, KEY_MAX
    sp = cfg.qpack(torch.as_tensor(st, device=cuda))
    hp = cfg.qpack(torch.as_tensor(hi, device=cuda))
    roots = t.root.expand(k).contiguous()
    depth = TREF.ref_delta_walk_fused(t.value, t.child, roots, sp, height=3,
                                      max_rounds=10_000)[3]
    assert int(depth[1:].min()) > 32
    for cap in (10_000, 37, 500, 1001):
        args = (t.value, t.mark, t.child, roots, sp, hp)
        kw = dict(height=3, max_out=10, pmask=cfg.pmask, max_rounds=cap)
        got = TVS.veb_scan_fused(*args, **kw)
        want = TREF.ref_delta_scan_fused(*args, **kw)
        _equal(want, got, SCAN, ("deep", cap))
        assert (got[1] > 0).any()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("payload_bits", [0, 12])
@pytest.mark.parametrize("height", [10, 12])
def test_cuda_scan_kernel_tall_rows(cuda, height, payload_bits):
    """ΔNodes of 1023 and 4095 slots: the block's rows take more than the
    48 KB default (the launch opts in), and at height 12 with 64-bit rows
    fewer lanes share a block so that they fit; the kernel equals its
    plain version."""
    from repro_torch.kernels import ops as TOPS

    cfg = TDT.TreeConfig(height=height, max_dnodes=512, buf_cap=8,
                         payload_bits=payload_bits, engine="lockstep")
    rng = np.random.default_rng(height + payload_bits)
    vals = np.unique(rng.integers(1, 400_000, 30_000))
    t = TDT.bulk_build(cfg, vals, vals % 4096 if payload_bits else None,
                       device=cuda)
    kinds = rng.choice([1, 2, 2], 512).astype(np.int32)
    keys = rng.choice(vals, 512).astype(np.int32)
    kinds[::3] = 1
    keys[::3] = rng.integers(1, 400_000, keys[::3].size)
    t, _, _ = TDT.update_batch(cfg, t, kinds, keys)
    k = 1027
    st = rng.integers(0, 410_000, k).astype(np.int32)
    hi = (st + rng.integers(1, 3_000, k)).astype(np.int32)
    sp = cfg.qpack(torch.as_tensor(st, device=cuda))
    hp = cfg.qpack(torch.as_tensor(hi, device=cuda))
    roots = t.root.expand(k).contiguous()
    cap = TOPS.scan_round_cap(height, cfg.max_dnodes, 32)
    args = (t.value, t.mark, t.child, roots, sp, hp)
    kw = dict(height=height, max_out=32, pmask=cfg.pmask, max_rounds=cap)
    got = TVS.veb_scan_fused(*args, **kw)
    want = TREF.ref_delta_scan_fused(*args, **kw)
    _equal(want, got, SCAN, (height, payload_bits))
    assert (got[1] > 0).any() and got[3].any()


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


def _paged_inputs(rng, device, dtype, b=8, max_len=2048, lens=None, qh=32,
                  kvh=8):
    """Granite-width paged decode inputs (QH 32, KVH 8, D 128, PS 16, or
    other heads): lengths in 1..max_len with a 0 and a one-page length (or
    ``lens``), tables from a random permutation with -1 tails, unreferenced
    pages scrambled."""
    d, ps = 128, 16
    maxp = max_len // ps
    if lens is None:
        lens = rng.integers(1, max_len + 1, b).astype(np.int32)
        lens[0], lens[1] = 0, ps
    lens = np.asarray(lens, np.int32)
    need = -(-lens // ps)
    n_pages = int(need.sum()) + 64
    bt = np.full((b, maxp), -1, np.int32)
    perm = rng.permutation(n_pages)
    c = 0
    for i in range(b):
        bt[i, :need[i]] = perm[c:c + need[i]]
        c += need[i]
    kp = rng.standard_normal((n_pages, ps, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, kvh, d)).astype(np.float32)
    unused = perm[c:]
    kp[unused], vp[unused] = 1e3, -1e3
    q = rng.standard_normal((b, qh, d)).astype(np.float32)
    return [torch.as_tensor(x).to(device=device, dtype=dt) for x, dt in
            ((q, dtype), (kp, dtype), (vp, dtype), (bt, torch.int32),
             (lens, torch.int32))]


def _paged_err(got, want):
    """|got - want| and its tolerance: 2e-5, plus in bfloat16 one bf16
    rounding step at each element's magnitude (both round an f32
    result)."""
    err = (got.float() - want.float()).abs()
    tol = torch.full_like(err, 2e-5)
    if got.dtype == torch.bfloat16:
        mag = want.float().abs().clamp(min=2.0 ** -126)
        tol = tol + torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return err, tol


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_attention_equals_plain(cuda, dtype):
    """The CUDA paged decode-attention kernel against its plain version on
    the same card inputs: within 2e-5 in float32 (other summation order),
    and in bfloat16 within 2e-5 plus one bf16 rounding step at each
    element's magnitude (both round an f32 result); length 0 gives 0.
    Drawn lengths, then lengths on the split plan's chunk boundaries
    (one chunk, one chunk + 1 token, a partial last page in the last
    chunk, the full MAXP, 0 and 1), then a batch the plan does not split;
    a call counts one launch however many kernels it runs."""
    from repro_torch.kernels.delta_paged_attention import (
        paged_decode_attention,
        split_plan,
    )

    rng = np.random.default_rng(21)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits, pps = split_plan(8, 8, 2048 // 16, sms)
    assert splits > 1
    chunk = pps * 16
    assert split_plan(8, 8, 128 // 16, sms)[0] == 1
    cases = [(2048, None),
             (2048, [0, 1, 16, chunk, chunk + 1, 2041, 2048, 700]),
             (128, [0, 1, 16, 17, 100, 128, 5, 64])]
    for max_len, lens in cases:
        args = _paged_inputs(rng, cuda, dtype, max_len=max_len, lens=lens)
        launches = paged_decode_attention.launches
        got = paged_decode_attention(*args)
        want = TREF.ref_paged_decode_attention(*args)
        torch.cuda.synchronize()
        assert paged_decode_attention.launches == launches + 1
        assert got.dtype == dtype and got.shape == args[0].shape
        err, tol = _paged_err(got, want)
        assert bool((err <= tol).all()), (max_len, lens, float(err.max()))
        assert bool((got[0] == 0).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(48, 4), (16, 1)], ids=["g12", "g16"])
def test_cuda_paged_attention_large_groups(cuda, heads, dtype):
    """Groups of more than 8 query heads a KV head (StarCoder2-15B's 48 /
    4, and 16 / 1), which the kernel splits into sub-groups of at most 8
    heads, against the plain version within the tolerance above, split and
    unsplit, length 0 giving 0."""
    from repro_torch.kernels.delta_paged_attention import (
        paged_decode_attention,
    )

    rng = np.random.default_rng(23)
    qh, kvh = heads
    for max_len, lens in ((2048, None), (128, [0, 1, 16, 17, 100, 128, 5,
                                               64])):
        args = _paged_inputs(rng, cuda, dtype, max_len=max_len, lens=lens,
                             qh=qh, kvh=kvh)
        launches = paged_decode_attention.launches
        got = paged_decode_attention(*args)
        want = TREF.ref_paged_decode_attention(*args)
        torch.cuda.synchronize()
        assert paged_decode_attention.launches == launches + 1
        err, tol = _paged_err(got, want)
        assert bool((err <= tol).all()), (heads, max_len, float(err.max()))
        assert bool((got[0] == 0).all())


@pytest.mark.requires_cuda
def test_cuda_paged_attention_smem_matches_the_wrapper(cuda):
    """The wrapper's shared-memory formula (its `_check` limit) equals the
    kernel's own, so the limit it holds on the CPU is the card's."""
    import ctypes

    from repro_torch.kernels import delta_paged_attention as TPA
    from repro_torch.kernels.build import library

    fn = library("paged_attention.cu").paged_decode_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    for ps, d, g, elt in ((16, 128, 4, 2), (16, 128, 4, 4), (4, 16, 2, 4),
                          (8, 64, 8, 2), (32, 256, 3, 2), (1, 32, 1, 4),
                          (16, 128, 12, 2), (16, 128, 12, 4), (16, 128, 16, 4),
                          (8, 64, 9, 2)):
        assert fn(ps, d, g, elt) == TPA.smem_bytes(ps, d, g, elt)


@pytest.mark.requires_cuda
def test_cuda_serve_engine_equals_cpu(cuda):
    """ServeEngine on the card (float32 smoke config, lockstep lookups)
    gives the CPU run's tokens, block tables and pager arena; every decode
    step launches the paged kernel once per layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.delta_paged_attention import (
        paged_decode_attention,
    )
    from repro_torch.models.transformer import Transformer
    from repro_torch.models.weights import load_state
    from repro_torch.serving import PagerConfig, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("granite_8b")
    gm = Transformer(cfg, device=cuda, seed=0)
    cm = load_state(Transformer(cfg, device="cpu", init=False),
                    {k: v.cpu().numpy() for k, v in gm.state_dict().items()})
    pc = PagerConfig(num_pages=64, page_size=4, max_blocks=64,
                     tree_height=4, engine="lockstep")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 3, 7)]
    runs = []
    for model in (cm, gm):
        eng = ServeEngine(cfg, model, pc, max_batch=4)
        tables = []
        bt_fn = eng.pager.block_tables
        eng.pager.block_tables = lambda s, n: tables.append(bt_fn(s, n)) \
            or tables[-1]
        launches = paged_decode_attention.launches
        sids = [eng.submit(p, max_new=6) for p in prompts]
        for _ in range(8):
            eng.step()
        runs.append(([eng.active[s].out for s in sids],
                     [t.cpu() for t in tables], eng.pager,
                     paged_decode_attention.launches - launches))
    (ct, cb, cp, cl), (gt, gb, gp, gl) = runs
    assert ct == gt
    assert all(torch.equal(a, b) for a, b in zip(cb, gb))
    assert cp.free_pages == gp.free_pages and cp.stats == gp.stats
    for name, a, b in zip(TDT.DeltaTree._fields, cp.index.state,
                          gp.index.state):
        assert torch.equal(a, b.cpu()), name
    assert cl == 0 and gl == cfg.num_layers * len(gb)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("payload_bits", [0, 12])
def test_cuda_kernels_on_fused_forest_view(cuda, payload_bits):
    """On the fused view of an 8-shard forest (per-lane roots at every
    shard's root), the walk and scan kernels equal their plain versions
    exactly: lanes in batch order (most blocks mix shards, so most lanes
    miss the block's staged root), lanes sorted by shard, and the scan's
    shard-major tiling at k % 4 != 0 (blocks straddle two shards)."""
    from repro_torch.core import engine as TE
    from repro_torch.distributed import forest as TF
    from repro_torch.distributed import router as TR
    from repro_torch.kernels import ops as TOPS

    fcfg = TF.ForestConfig(num_shards=8, tree=TDT.TreeConfig(
        height=7, max_dnodes=1024, buf_cap=16, payload_bits=payload_bits,
        engine="lockstep"))
    rng = np.random.default_rng(20 + payload_bits)
    vals = np.unique(rng.integers(1, 400_000, 40_000))
    f = TF.bulk_build(fcfg, vals, vals % 4096 if payload_bits else None,
                      device=cuda)
    for _ in range(2):
        kinds = rng.choice([1, 2], 2048).astype(np.int32)
        keys = rng.integers(1, 400_000, 2048).astype(np.int32)
        f, _, _ = TF.update_batch(fcfg, f, kinds, keys)
    cfg = fcfg.tree
    view, roots = TE._fused_trees_view(cfg, f.trees)
    cap = cfg.walk_round_cap
    for k in (1, 33, 1000, 4093):
        keys = torch.as_tensor(rng.integers(0, 410_000, k).astype(np.int32),
                               device=cuda)
        sid = TR.shard_ids(f.splits, keys)
        for order in ("batch", "sorted"):
            lanes = (torch.arange(k, device=cuda) if order == "batch"
                     else torch.argsort(sid, stable=True))
            q = TE._walk_queries(cfg, keys[lanes]).contiguous()
            r = roots[sid[lanes].long()].contiguous()
            args = (view.value, view.child, r, q)
            got = TVS.veb_walk_fused(*args, height=7, max_rounds=cap)
            want = TREF.ref_delta_walk_fused(*args, height=7, max_rounds=cap)
            _equal(want, got, WALK, ("fused walk", k, order))
    for k, max_out in ((13, 16), (129, 128), (512, 128)):
        st = rng.integers(0, 400_000, k).astype(np.int32)
        hi = (st + rng.choice([50, 5_000, 400_000], k)).astype(np.int32)
        lid = torch.arange(8, dtype=torch.int32,
                           device=cuda).repeat_interleave(k)
        starts = TE._walk_queries(cfg, torch.as_tensor(st, device=cuda)
                                  .repeat(8)).contiguous()
        his = cfg.qpack(torch.as_tensor(hi, device=cuda).repeat(8))
        caps = TOPS.scan_round_cap(7, view.value.shape[0], max_out)
        args = (view.value, view.mark, view.child,
                roots[lid.long()].contiguous(), starts, his.contiguous())
        kw = dict(height=7, max_out=max_out, pmask=int(cfg.pmask),
                  max_rounds=caps)
        _equal(TREF.ref_delta_scan_fused(*args, **kw),
               TVS.veb_scan_fused(*args, **kw), SCAN, ("scan", k, max_out))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("policy", ["eager", "deferred"])
def test_cuda_forest_equals_cpu_forest(cuda, policy):
    """The forest on the card (fused and dense reads, updates, scans)
    leaves every shard's arena and every read equal to the same run on the
    CPU; the fused search launches the walk kernel once per batch."""
    from repro_torch.distributed import forest as TF

    rng = np.random.default_rng(5)
    init = np.unique(rng.integers(1, 60_000, 6_000)).astype(np.int32)
    kw = dict(num_shards=8, height=5, max_dnodes=1024, buf_cap=8,
              engine="lockstep", maintenance=policy)
    gix = make_index("forest", initial=init, device=cuda, **kw)
    cix = make_index("forest", initial=init, device="cpu", **kw)
    gdense = make_index("forest", initial=init, device=cuda, fused=False,
                        **kw)
    for step in range(5):
        kinds = rng.choice([0, 1, 1, 2], 509).astype(np.int32)
        keys = rng.integers(1, 62_000, 509).astype(np.int32)
        keys[:64] = (rng.choice(init, 8)[:, None] + np.arange(1, 9)).ravel()
        kinds[:64] = 1
        n0 = TVS.veb_walk_fused.launches
        got = gix.search(keys)
        assert TVS.veb_walk_fused.launches == n0 + 1
        _equal(cix.search(keys), got, ("found", "hops"), step)
        _equal(got, gdense.search(keys), ("found", "hops"), step)
        _equal(cix.successor(keys), gix.successor(keys), ("found", "succ"),
               step)
        st = keys[:61]
        _equal(cix.successor_k(st, 9), gix.successor_k(st, 9),
               ("keys", "pays", "n", "hops", "more"), step)
        batch = OpBatch.mixed(kinds, keys)
        gix, gres, gst = gix.update(batch)
        gdense, _, _ = gdense.update(batch)
        cix, cres, cst = cix.update(batch)
        assert torch.equal(gres.cpu(), cres) and gst == cst, step
        for name, a, b in zip(TDT.DeltaTree._fields, cix.state.trees,
                              gix.state.trees):
            assert torch.equal(a, b.cpu()), (step, name)
    if policy == "deferred":
        assert int((gix.state.trees.bcount.sum(1) > 0).sum()) >= 2
    assert [k for k, _ in gix.live_items()] == \
        [k for k, _ in cix.live_items()]
    assert not gix.alloc_failed() and not TF.alloc_failed(cix.state)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["SortedArray", "StaticVEB", "PointerBST",
                                  "HashTable"])
def test_cuda_baselines_equal_cpu(cuda, name):
    """Each comparison structure built, searched and (but the hash table)
    updated on the card equals the same calls on the CPU: results and
    every state field, through three update batches that cross a full
    sorted array and revive marked BST nodes."""
    from repro_torch.core import baselines as BL

    cls = getattr(BL, name)
    rng = np.random.default_rng(7)
    vals = np.unique(rng.integers(1, 200_000, 50_000)).astype(np.int32)
    kw = dict(cap=vals.size + 40) if name == "SortedArray" else {}
    c, g = cls.build(vals, device="cpu", **kw), cls.build(vals, device=cuda,
                                                          **kw)

    def same_state(where):
        for f, a, b in zip(c._fields, c, g):
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b.cpu()), \
                    (where, f)
            else:
                assert a == b, (where, f)

    same_state("build")
    q = rng.integers(1, 210_000, 4096).astype(np.int32)
    assert torch.equal(cls.search(c, q), cls.search(g, q).cpu())
    if name == "HashTable":
        return
    for step in range(3):
        kinds = rng.choice([1, 2], 1024).astype(np.int32)
        keys = rng.integers(1, 210_000, 1024).astype(np.int32)
        keys[:32] = keys[32:64]
        c, cres = cls.update(c, kinds, keys)
        g, gres = cls.update(g, kinds, keys)
        assert torch.equal(cres, gres.cpu()), step
        same_state(step)
        assert torch.equal(cls.search(c, q), cls.search(g, q).cpu())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("payload_bits", [0, 12])
def test_cuda_transfer_stats_equal_cpu(cuda, payload_bits):
    """``obs.transfers.measure`` and a stats-collecting read (kernel 2 on
    the card) give the same ReadStats on the card as on the CPU."""
    import dataclasses

    from repro_torch.obs import transfers as OTR

    rng = np.random.default_rng(payload_bits + 1)
    vals = np.unique(rng.integers(1, 400_000, 100_000))
    cfg = TDT.TreeConfig(height=7, max_dnodes=6000, buf_cap=16,
                         payload_bits=payload_bits, engine="lockstep",
                         collect_stats=True, collect_transfers=True)
    pays = vals % 4096 if payload_bits else None
    c = TDT.bulk_build(cfg, vals, pays, device="cpu")
    g = TDT.bulk_build(cfg, vals, pays, device=cuda)
    kinds = rng.choice([1, 2], 2048).astype(np.int32)
    keys = rng.integers(1, 400_000, 2048).astype(np.int32)
    c, _, _ = TDT.update_batch(cfg, c, kinds, keys)
    g, _, _ = TDT.update_batch(cfg, g, kinds, keys)
    q = rng.integers(1, 410_000, 4096).astype(np.int32)
    q[:5] = np.iinfo(np.int32).max
    want, got = OTR.measure(cfg, c, q), OTR.measure(cfg, g, q)
    for f, a, b in zip(want._fields, want, got):
        assert torch.equal(a, b.cpu()), f
    n0 = TVS.veb_walk_fused.launches
    cs, gs = TDT.lookup_batch(cfg, c, q), TDT.lookup_batch(cfg, g, q)
    assert TVS.veb_walk_fused.launches == n0 + 1
    _equal(cs[:3], gs[:3], ("found", "payload", "hops"), payload_bits)
    for leg in ("search", "transfers"):
        for f, a, b in zip(getattr(cs[3], leg)._fields,
                           getattr(cs[3], leg), getattr(gs[3], leg)):
            assert torch.equal(a, b.cpu()), (leg, f)
    plain = TDT.lookup_batch(dataclasses.replace(cfg, collect_stats=False),
                             g, q)
    _equal(plain, gs[:3], ("found", "payload", "hops"), "stats off")
