"""PyTorch port: measured memory-transfer accounting (`obs.transfers`,
`core.transfers`; mirrors tests/test_transfers.py).

The same numpy inputs go through the JAX functions and the port's: the
touch traces, ``measure``'s ``TransferStats`` (every field, exactly) on
quiescent and churned trees, ``fit_log_b``'s points and fit.  On a
quiescent tree the measured distinct-block transfers equal the analytical
`count_block_transfers` exactly (ratio 1.0 at every block size), and the
measured statistic is the same under both engines and both forest
dispatches, because it is derived in the dispatch layer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import deltatree as JDT
from repro.core import layout
from repro.core import transfers as JCT
from repro.obs import transfers as JOT
from repro_torch.core import deltatree as TDT
from repro_torch.core import transfers as TCT
from repro_torch.distributed import forest as TF
from repro_torch.distributed.forest import ForestConfig
from repro_torch.obs import transfers as TOT
from repro_torch.obs.stats import (
    TRANSFER_BLOCK_SIZES, ReadStats, TransferStats,
)

from _torch_parity import (
    assert_stats_equal, jax_npz, np_of, port_cfg, stack_stats, to_port,
    few_jax_executables,  # noqa: F401  (autouse)
)

KEYS = np.arange(10, 400, 7, dtype=np.int64)
JCFG = JDT.TreeConfig(height=4, max_dnodes=256, buf_cap=8,
                      collect_stats=True, collect_transfers=True)


def _queries():
    """Hits, misses and born-resolved ROUTE_LEFT sentinel lanes."""
    return np.asarray(list(KEYS[:6]) + [5, 11, 401, layout.ROUTE_LEFT,
                                        layout.ROUTE_LEFT], np.int32)


def _tree(height: int, n: int, churn: int):
    """(JAX cfg, JAX tree, probes): a bulk-built tree of ~``n`` keys after
    ``churn`` eager update batches of 64 mixed ops."""
    rng = np.random.default_rng(height)
    keys = np.unique(rng.integers(1, 50_000, size=n).astype(np.int64))
    jcfg = dataclasses.replace(JCFG, height=height, max_dnodes=4096)
    jt = JDT.bulk_build(jcfg, keys)
    for _ in range(churn):
        kinds = rng.choice([1, 2], 64).astype(np.int32)
        ks = rng.integers(1, 50_000, 64).astype(np.int32)
        jt, _, _ = JDT.update_batch(jcfg, jt, jnp.asarray(kinds),
                                    jnp.asarray(ks))
    q = rng.integers(1, 50_000, size=256).astype(np.int32)
    q[:3] = layout.ROUTE_LEFT
    return jcfg, jt, q


@pytest.mark.parametrize("churn", [0, 3])
@pytest.mark.parametrize("height,n", [(4, 300), (5, 900), (7, 2500)])
def test_measure_equals_jax(height, n, churn):
    jcfg, jt, q = _tree(height, n, churn)
    cfg, t = to_port(jcfg, jt)
    assert_stats_equal(JOT.measure(jcfg, jt, jnp.asarray(q)),
                       TOT.measure(cfg, t, q), f"h{height} churn {churn}")


@pytest.mark.parametrize("height,n", [(4, 300), (5, 900), (7, 2500)])
def test_touch_and_hops_fns_equal_jax(height, n):
    jcfg, jt, q = _tree(height, n, 0)
    cfg, t = to_port(jcfg, jt)
    jtouch, ttouch = JCT.delta_touch_fn(jcfg, jt), TCT.delta_touch_fn(cfg, t)
    jhops, thops = JCT.delta_hops_fn(jcfg, jt), TCT.delta_hops_fn(cfg, t)
    for k in q[3:].tolist():
        assert ttouch(k) == jtouch(k)
        assert thops(k) == jhops(k)


@pytest.mark.parametrize("height,n", [(4, 300), (5, 900), (7, 2500)])
def test_measured_equals_model_exactly(height, n):
    """On a quiescent tree, measured == model at every block size: ratio
    1.0, not approximately."""
    jcfg, jt, q = _tree(height, n, 0)
    cfg, t = to_port(jcfg, jt)
    cm = TOT.compare_model(cfg, t, q[3:])
    assert sorted(cm) == list(TRANSFER_BLOCK_SIZES)
    for b in TRANSFER_BLOCK_SIZES:
        assert cm[b]["measured"] == cm[b]["model"], (b, cm[b])
        assert cm[b]["ratio"] == 1.0


def test_transfer_stats_fields_and_pad_lanes():
    cfg, t = to_port(JCFG, JDT.bulk_build(JCFG, KEYS))
    q = _queries()
    ts = TOT.measure(cfg, t, q)
    assert isinstance(ts, TransferStats)
    assert np_of(ts.blocks).dtype == np_of(ts.queries).dtype == np.int32
    k = q.size
    d = ts.asdict()
    assert d["queries"] == k and d["pad_lanes"] == 2 and d["batches"] == 1
    assert d["buffer_probes"] == d["leaf_touches"] == k - 2
    assert d["dnode_visits"] >= k - 2 and d["router_touches"] > 0
    blocks = np_of(ts.blocks)
    assert all(blocks[i] >= blocks[i + 1] for i in range(blocks.size - 1))
    for b in TRANSFER_BLOCK_SIZES:
        assert d[f"blocks_b{b}"] == blocks[TRANSFER_BLOCK_SIZES.index(b)]
    # a batch of sentinels alone touches nothing
    pads = TOT.measure(cfg, t, np.full(8, layout.ROUTE_LEFT, np.int32))
    assert int(pads.pad_lanes) == 8 and int(pads.buffer_probes) == 0
    assert int(pads.dnode_visits) == int(pads.router_touches) == 0
    assert int(pads.leaf_touches) == 0 and int(pads.blocks.sum()) == 0


def test_transfer_stats_merge_reduce_equal_jax():
    jt = JDT.bulk_build(JCFG, KEYS)
    cfg, t = to_port(JCFG, jt)
    ja = JOT.measure(JCFG, jt, jnp.asarray(_queries()))
    a = TOT.measure(cfg, t, _queries())
    assert_stats_equal(ja.merge(ja), a.merge(a), "merge")
    jr = type(ja).reduce(jax.tree.map(lambda *xs: jnp.stack(xs), ja, ja))
    red = TransferStats.reduce(stack_stats([a, a]))
    assert_stats_equal(jr, red, "reduce")
    assert_stats_equal(a.merge(a), red, "merge == reduce")
    assert_stats_equal(TransferStats.zero().merge(a), a, "zero")


def test_transfer_stats_engine_parity():
    """scalar and lockstep reads return the same ReadStats, transfers
    included, equal to JAX's."""
    q = _queries()
    jo = JDT.search_jit(JCFG, JDT.bulk_build(JCFG, KEYS), jnp.asarray(q))
    outs = {}
    for engine in ("scalar", "lockstep"):
        cfg = dataclasses.replace(port_cfg(JCFG), engine=engine)
        t = TDT.bulk_build(cfg, KEYS, device="cpu")
        outs[engine] = TDT.search_batch(cfg, t, q)[2]
        assert isinstance(outs[engine], ReadStats)
        assert_stats_equal(jo[2].transfers, outs[engine].transfers, engine)
    assert_stats_equal(outs["scalar"], outs["lockstep"], "engines")


@pytest.mark.parametrize("engine", ["scalar", "lockstep"])
def test_transfer_stats_forest_dispatch_parity(engine):
    """The fused and the dense forest dispatch give the same
    TransferStats (a shard-local replay over the stacked arenas, fed the
    same shard ids by both)."""
    q = _queries()
    outs = []
    for fused in (True, False):
        fcfg = ForestConfig(num_shards=4, fused=fused,
                            tree=dataclasses.replace(port_cfg(JCFG),
                                                     engine=engine))
        f = TF.bulk_build(fcfg, KEYS, device="cpu")
        outs.append(TF.search_batch(fcfg, f, q)[2])
    a, b = outs
    assert int(a.transfers.pad_lanes) == 2
    assert int(a.transfers.buffer_probes) == q.size - 2
    assert_stats_equal(a.transfers, b.transfers, engine)


def test_fit_log_b_equals_jax():
    """The size sweep fits c·log_B(N) + d with r2 >= 0.98 — the paper's
    O(log_B N) transfer bound, observed — at the same 11 points as JAX's,
    and the same fit within 1e-9 relative."""
    fit = TOT.fit_log_b(device="cpu")
    jfit = JOT.fit_log_b()
    assert len(fit["points"]) == 11
    assert fit["points"] == jfit["points"]
    assert fit["r2"] >= 0.98 and fit["c"] > 0
    for k in ("c", "d", "r2"):
        assert fit[k] == pytest.approx(jfit[k], rel=1e-9, abs=0), k
    assert fit["points"][-1][1] > fit["points"][0][1]


MAP_LEG = r"""
import numpy as np, jax.numpy as jnp
from repro.core import deltatree as DT
from repro.obs import transfers as OT
rec = {}
keys = np.arange(10, 4000, 7, dtype=np.int64)
cfg = DT.TreeConfig(height=5, max_dnodes=512, buf_cap=8, payload_bits=12,
                    collect_stats=True, collect_transfers=True,
                    engine="lockstep")
t = DT.bulk_build(cfg, keys, keys % 4096)
q = np.asarray(list(keys[::37]) + [5, 11, 4001, 2**31 - 1], np.int32)
for k, v in t._asdict().items():
    rec["tree/" + k] = np.asarray(v)
rec["q"] = q
ts = OT.measure(cfg, t, jnp.asarray(q))
for k, v in ts._asdict().items():
    rec["measure/" + k] = np.asarray(v)
found, pay, hops, rs = DT.lookup_jit(cfg, t, jnp.asarray(q))
for name, col in (("found", found), ("pay", pay), ("hops", hops)):
    rec["lookup/" + name] = np.asarray(col)
for k, v in rs.search._asdict().items():
    rec["search/" + k] = np.asarray(v)
"""


def test_map_mode_measure_and_lookup_stats_x64(tmp_path_factory):
    """Map mode (int64 packed rows, x64 on the JAX side): ``measure`` and
    a stats-collecting lookup's ReadStats equal JAX's.  Under x64 the JAX
    package's ``jnp.sum`` widens the int32 counters to int64 (a reference
    quirk, ROADMAP.md Queue 3); the port keeps int32, so the counters are
    compared by value and the port's dtype is checked on its own."""
    from _torch_parity import prefixed
    from repro_torch.core.deltatree import TreeConfig, from_numpy

    rec = jax_npz(tmp_path_factory, "torch_transfers_map", MAP_LEG)
    cfg = TreeConfig(height=5, max_dnodes=512, buf_cap=8, payload_bits=12,
                     collect_stats=True, collect_transfers=True,
                     engine="lockstep")
    t = from_numpy(cfg, prefixed(rec, "tree"), "cpu")
    q = rec["q"]
    ts = TOT.measure(cfg, t, q)
    for k, v in prefixed(rec, "measure").items():
        assert np_of(getattr(ts, k)).dtype == np.int32, k
        np.testing.assert_array_equal(np_of(getattr(ts, k)), v, err_msg=k)
    found, pay, hops, rs = TDT.lookup_batch(cfg, t, q)
    for name, col in (("found", found), ("pay", pay), ("hops", hops)):
        np.testing.assert_array_equal(np_of(col), rec["lookup/" + name])
    assert_stats_equal(rs.transfers, ts, "lookup transfers")
    for k, v in prefixed(rec, "search").items():
        got = np_of(getattr(rs.search, k))
        assert got.dtype == np.int32, k
        np.testing.assert_array_equal(got, v, err_msg=k)
