"""PyTorch port: ΔNodes taller than 12 levels, where the CUDA kernels read
the vEB position table from global memory and stage a root only where it
fits (``csrc/veb_walk.cu`` / ``csrc/veb_scan.cu``, their kTall
instantiations).

On the CPU the wrappers run their plain versions, so these tests hold the
port to the JAX package bit for bit at those heights, on the same numpy
inputs (made once by the port on the CPU from a seed and handed to the
JAX side, which runs in one subprocess a mode, x64 for map mode):

* `veb_walk_fused`, `veb_walk_rows` and `veb_scan_fused` at heights 13, 14
  and 16, set and map mode, on churned trees (bulk build, then eager
  update batches that leave tombstones and child ΔNodes), with sentinel
  lanes, per-lane roots at non-root ΔNodes, and scan round caps that cut
  lanes; against ``repro.kernels.ref`` (JAX's plain versions: its Pallas
  kernels in interpret mode cost minutes at these heights);
* a lockstep ``make_index("deltatree")`` at UB=N (height ceil(log2 n) + 2,
  4 ΔNodes: Table 1's row) on both sides: ``search`` (``lookup`` in map
  mode), ``successor``, two ``range_scan`` pages and one
  ``insert_delete`` batch, results and arenas equal;
* the kernels' height limits: 1 to 30 on the card, any height >= 1 on
  the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import OpBatch, make_index
from repro_torch.core import deltatree as DT
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import veb_search as VS

from _subproc import run_py
from _torch_parity import (
    assert_trees_equal,
    few_jax_executables,  # noqa: F401  (autouse)
    prefixed,
    shared_npz,
)

TALL = (13, 14, 16)
# (keys drawn, key range) a height: enough for child ΔNodes after the churn
SIZES = {13: (3000, 40_000), 14: (6000, 40_000), 16: (20_000, 200_000)}
K = 256            # walk lanes
SCAN_K = 64        # scan lanes
MAX_OUT = 16
SCAN_CAPS = (None, 9, 10)   # the derived cap, and two that cut lanes
WALK = ("leaf_val", "leaf_b", "final_dn", "hops", "cand")
ROWS = ("leaf_val", "leaf_b", "next_dn", "cand")
SCAN = ("out", "n", "hops", "more")
UBN_KEYS = (3000, 40_000)   # UB=N: 2,896 keys -> height 14


def _tall_tree(height: int, payload_bits: int):
    rng = np.random.default_rng(10 * height + payload_bits)
    n, hi = SIZES[height]
    cfg = DT.TreeConfig(height=height, max_dnodes=64, buf_cap=8,
                        payload_bits=payload_bits, engine="lockstep")
    vals = np.unique(rng.integers(1, hi, n)).astype(np.int32)
    t = DT.bulk_build(cfg, vals, vals % 97 if payload_bits else None,
                      device="cpu")
    for _ in range(3):
        kinds = rng.choice([1, 1, 2], 256).astype(np.int32)
        keys = rng.integers(1, hi, 256).astype(np.int32)
        keys[kinds == 2] = rng.choice(vals, int((kinds == 2).sum()))
        t, _, _ = DT.update_batch(cfg, t, kinds, keys, keys % 97)
    assert not bool(t.alloc_fail)
    return cfg, t, rng


def kernel_inputs(height: int, payload_bits: int) -> dict:
    """A churned tree's arena and the lanes of the three kernels, as numpy:
    walk queries (present, absent, above every key, 3 sentinels) with 1
    root in 4 at a live non-root ΔNode; the rows the per-round walk
    gathers in its first round (padded as a caller may pad them); scan
    bands from just below live keys, one lane born done."""
    cfg, t, rng = _tall_tree(height, payload_bits)
    _, hi = SIZES[height]
    live = DT.live_keys(cfg, t)
    q = rng.integers(1, hi + 1000, K).astype(np.int32)
    half = rng.random(K) < 0.4
    q[half] = rng.choice(live, int(half.sum()))
    qp = cfg.qpack(torch.as_tensor(q))
    qp[:3] = TREF.walk_big(cfg.vdtype)
    alive = np.flatnonzero(t.alive.numpy())
    assert alive.size > 1, "the churn left one ΔNode"
    roots = np.full(K, int(t.root), np.int32)
    pick = rng.random(K) < 0.25
    roots[pick] = rng.choice(alive, int(pick.sum()))
    d = torch.as_tensor(roots).long()
    rows = torch.cat([t.value[d], torch.zeros(K, 3, dtype=t.value.dtype)], 1)
    crows = torch.cat([t.child[d], torch.full((K, 1), -7, dtype=torch.int32)],
                      1)
    st = rng.choice(live, SCAN_K).astype(np.int32) - 1
    sh = (st + rng.integers(1, hi // 20, SCAN_K)).astype(np.int32)
    sp = cfg.qpack(torch.as_tensor(st))
    sp[0] = TREF.walk_big(cfg.vdtype)
    sroots = np.full(SCAN_K, int(t.root), np.int32)
    sroots[::4] = rng.choice(alive, sroots[::4].size)
    arrays = DT.to_numpy(t)
    return dict(value=arrays["value"], mark=arrays["mark"],
                child=arrays["child"], roots=roots, q=qp.numpy(),
                rows=rows.numpy(), crows=crows.numpy(), starts=sp.numpy(),
                his=cfg.qpack(torch.as_tensor(sh)).numpy(), sroots=sroots,
                walk_cap=np.int64(cfg.walk_round_cap),
                scan_cap=np.int64(OPS.scan_round_cap(height, cfg.max_dnodes,
                                                     MAX_OUT)),
                pmask=np.int64(cfg.pmask))


def index_inputs(payload_bits: int) -> dict:
    """Table 1's UB=N recipe at a few thousand keys: the keys (payloads in
    map mode), 500 read queries, two scan pages' bounds and one update
    batch."""
    rng = np.random.default_rng(7 + payload_bits)
    n, hi = UBN_KEYS
    keys = np.unique(rng.integers(1, hi, n)).astype(np.int32)
    kinds = rng.choice([0, 1, 2], 256).astype(np.int32)
    bkeys = rng.integers(1, hi, 256).astype(np.int32)
    bkeys[kinds == 2] = rng.choice(keys, int((kinds == 2).sum()))
    return dict(ix_keys=keys, ix_pays=(keys % 4001).astype(np.int32),
                ix_q=rng.integers(0, hi + 500, 500).astype(np.int32),
                ix_scan=np.array([100, 9000], np.int32),
                ix_kinds=kinds, ix_bkeys=bkeys,
                ix_bpays=(bkeys % 4001).astype(np.int32),
                ix_height=np.int64(int(np.ceil(np.log2(keys.size))) + 2))


def index_ops(make_index, OpBatch, inp, payload_bits, asarray, device=None):
    """The UB=N leg, written once for both packages: ``make_index`` /
    ``OpBatch`` / ``asarray`` are the package's, ``device`` the port's.
    Returns (record of numpy arrays, final index)."""
    kw = dict(height=int(inp["ix_height"]), max_dnodes=4, buf_cap=16,
              engine="lockstep")
    if payload_bits:
        kw.update(payloads=inp["ix_pays"], payload_bits=payload_bits)
    if device is not None:
        kw["device"] = device
    ix = make_index("deltatree", initial=inp["ix_keys"], **kw)
    q = asarray(inp["ix_q"])
    rec = {}
    if payload_bits:
        rec["found"], rec["payload"], rec["hops"] = ix.lookup(q)
    else:
        rec["found"], rec["hops"] = ix.search(q)
    rec["succ_found"], rec["succ"] = ix.successor(q)
    lo, hi = (int(x) for x in inp["ix_scan"])
    page = ix.range_scan(lo, hi)
    page2 = ix.range_scan(lo, hi, cursor=page.cursor)
    rec["page_keys"], rec["page_pays"] = page.keys, page.payloads
    rec["page_more"] = np.array([page.more, page2.more])
    rec["page2_keys"], rec["page2_pays"] = page2.keys, page2.payloads
    batch = OpBatch.mixed(asarray(inp["ix_kinds"]), asarray(inp["ix_bkeys"]),
                          asarray(inp["ix_bpays"]))
    ix, rec["update"] = ix.insert_delete(batch)
    rec["found_after"] = ix.search(q)[0]
    return {k: np.asarray(v) for k, v in rec.items()}, ix


_JAX_CODE = r'''
import numpy as np
import jax.numpy as jnp
from repro.api import OpBatch, make_index
from repro.kernels import ref as R
from test_torch_tall import SCAN_CAPS, MAX_OUT, TALL, index_ops
from _torch_parity import jax_arrays, prefixed

BITS = {bits}
with np.load({inputs!r}) as z:
    inp = {{k: z[k] for k in z.files}}
rec = dict(inp)
for h in TALL:
    x = {{k: jnp.asarray(v) for k, v in prefixed(inp, str(h)).items()}}
    walk = R.ref_delta_walk_fused(x["value"], x["child"], x["roots"], x["q"],
                                  height=h, max_rounds=int(x["walk_cap"]))
    for i, a in enumerate(walk):
        rec[f"{{h}}/walk{{i}}"] = np.asarray(a)
    rows = R.ref_veb_walk_rows(x["rows"], x["crows"], x["q"], height=h)
    for i, a in enumerate(rows):
        rec[f"{{h}}/rows{{i}}"] = np.asarray(a)
    for c, cap in enumerate(SCAN_CAPS):
        scan = R.ref_delta_scan_fused(
            x["value"], x["mark"], x["child"], x["sroots"], x["starts"],
            x["his"], height=h, max_out=MAX_OUT, pmask=int(x["pmask"]),
            max_rounds=int(cap or x["scan_cap"]))
        for i, a in enumerate(scan):
            rec[f"{{h}}/scan{{c}}_{{i}}"] = np.asarray(a)
got, ix = index_ops(make_index, OpBatch, inp, BITS, jnp.asarray)
rec.update({{f"ix/{{k}}": v for k, v in got.items()}})
rec.update({{f"ix_state/{{k}}": v for k, v in jax_arrays(ix.state).items()}})
'''


def _jax_side(tmp_path_factory, payload_bits: int) -> dict:
    """The inputs of both legs and JAX's results on them, once a test run
    for every xdist worker."""
    import os
    from pathlib import Path

    tests = str(Path(__file__).resolve().parent)

    def make(path):
        inputs = f"{path}.inputs.npz"
        arrays = index_inputs(payload_bits)
        for h in TALL:
            arrays.update({f"{h}/{k}": v for k, v in
                           kernel_inputs(h, payload_bits).items()})
        np.savez(inputs, **arrays)
        tmp = f"{path}.part.npz"
        code = (f"import sys\nsys.path.insert(0, {tests!r})\n"
                + _JAX_CODE.format(bits=payload_bits, inputs=inputs)
                + f"np.savez({tmp!r}, **rec)\n")
        run_py(code, x64=bool(payload_bits), timeout=900)
        os.replace(tmp, path)
        os.unlink(inputs)

    return shared_npz(tmp_path_factory, f"torch_tall_{payload_bits}", make)


@pytest.fixture(scope="module")
def jax_set(tmp_path_factory):
    return _jax_side(tmp_path_factory, 0)


@pytest.fixture(scope="module")
def jax_map(tmp_path_factory):
    return _jax_side(tmp_path_factory, 12)


def _rec(request, payload_bits):
    return request.getfixturevalue("jax_map" if payload_bits else "jax_set")


def _equal(want: dict, prefix: str, got, names, where):
    for i, (name, b) in enumerate(zip(names, got)):
        a = want[f"{prefix}{i}"]
        assert a.dtype == b.numpy().dtype, (where, name)
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f"{where} {name}")


@pytest.mark.parametrize("payload_bits", [0, 12])
@pytest.mark.parametrize("height", TALL)
def test_tall_kernels_equal_jax(request, height, payload_bits):
    """The port's three kernel wrappers (their plain versions here) equal
    JAX's plain versions on the same tall arenas and lanes, bit for bit;
    the walks need more than one ΔNode and the caps cut scan lanes."""
    rec = _rec(request, payload_bits)
    x = {k: torch.as_tensor(v) for k, v in prefixed(rec, str(height)).items()}
    where = f"height {height}, payload bits {payload_bits}"
    walk = VS.veb_walk_fused(x["value"], x["child"], x["roots"], x["q"],
                             height=height, max_rounds=int(x["walk_cap"]))
    _equal(rec, f"{height}/walk", walk, WALK, where)
    assert int(walk[3].max()) >= 2, "no lane left its first ΔNode"
    rows = VS.veb_walk_rows(x["rows"], x["crows"], x["q"], height=height)
    _equal(rec, f"{height}/rows", rows, ROWS, where)
    cut = 0
    for c, cap in enumerate(SCAN_CAPS):
        cap = cap or int(x["scan_cap"])
        scan = VS.veb_scan_fused(x["value"], x["mark"].bool(), x["child"],
                                 x["sroots"], x["starts"], x["his"],
                                 height=height, max_out=MAX_OUT,
                                 pmask=int(x["pmask"]), max_rounds=cap)
        _equal(rec, f"{height}/scan{c}_", scan, SCAN, f"{where}, cap {cap}")
        cut += int((scan[2] == cap).sum())
    assert cut > 0, "no scan lane reached a cap"


@pytest.mark.parametrize("payload_bits", [0, 12])
def test_ubn_index_equals_jax(request, payload_bits):
    """Table 1's UB=N ΔTree (one ΔNode of height ceil(log2 n) + 2 holds
    the whole set) under the lockstep engine: reads, scan pages, an
    update batch and the arena equal the JAX package's."""
    rec = _rec(request, payload_bits)
    got, ix = index_ops(make_index, OpBatch, rec, payload_bits,
                        lambda a: a, device="cpu")
    assert int(rec["ix_height"]) > VS.SMEM_HEIGHT
    for name, v in got.items():
        want = rec[f"ix/{name}"]
        np.testing.assert_array_equal(want, v, err_msg=name)
    keys = rec["ix_keys"]
    np.testing.assert_array_equal(got["found"], np.isin(rec["ix_q"], keys))
    assert_trees_equal(prefixed(rec, "ix_state"), ix.state, "after update")


@pytest.mark.parametrize("height", [1, 12, 13, 22, 30])
def test_kernel_height_limits(height):
    """The kernels take heights 1-30 (int32 slot indices), the plain
    versions any height >= 1; 0 and 31 are refused with the reason."""
    VS._check_height(height)
    VS._check_kernel("veb_walk_fused", height)
    with pytest.raises(ValueError, match="height must be >= 1"):
        VS._check_height(0)
    with pytest.raises(ValueError, match="1..30"):
        VS._check_kernel("veb_walk_fused", 31)
