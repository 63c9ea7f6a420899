"""YCSB's generators and the traffic the generic generator draws."""

from __future__ import annotations

import numpy as np

from portbench.bench import data, traffic
from portbench.traffic import ycsb


def test_fnv_matches_a_byte_loop():
    def fnv(v):
        h = 0xCBF29CE484222325
        for _ in range(8):
            h ^= v & 0xFF
            v >>= 8
            h = (h * 1099511628211) % 2**64
        s = h - 2**64 if h >= 2**63 else h
        return abs(s)

    vals = [0, 1, 255, 256, 4_000_000, 2**40 + 17]
    assert ycsb.fnvhash64(vals).tolist() == [fnv(v) for v in vals]


def test_records_distinct_and_in_range():
    k = ycsb.record_keys(50_000)
    assert np.unique(k).size == k.size
    assert k.min() >= 1 and k.max() <= 2**31 - 2
    assert (ycsb.record_keys(1000) == k[:1000]).all()


def test_zipfian_deterministic_per_seed():
    a = ycsb.scrambled_zipfian(np.random.default_rng(5), 10_000, 100_000)
    b = ycsb.scrambled_zipfian(np.random.default_rng(5), 10_000, 100_000)
    c = ycsb.scrambled_zipfian(np.random.default_rng(6), 10_000, 100_000)
    assert (a == b).all() and not (a == c).all()
    assert a.min() >= 0 and a.max() < 100_000


def test_zipfian_hot_set_is_skewed_and_scattered():
    n = 1_000_000
    z = ycsb.scrambled_zipfian(np.random.default_rng(1), 400_000, n)
    counts = np.bincount(z, minlength=n)
    hot = np.argsort(-counts)[:100]
    # skewed: the 100 hottest items take a large share of the draws
    assert counts[hot].sum() > 0.2 * z.size
    # scattered: they lie all over the item range, not at its start
    assert hot.min() < n // 10 and hot.max() > 9 * n // 10
    assert np.histogram(hot, bins=10, range=(0, n))[0].min() >= 2


def test_ycsb_e_shares_and_fresh_inserts():
    mix = {"batch": 2000, "reads": {"op": "successor_k", "share": 0.95,
                                    "k": 100, "lengths": [1, 100],
                                    "keys": {"dist": "scrambled_zipfian",
                                             "theta": 0.99}},
           "updates": {"kind": "insert_fresh"}, "pool_steps": 3,
           "max_steps": 5}
    cfg = {"data": {"kind": "ycsb_hashed", "recordcount": 30_000}}
    ds = data.make(cfg, np.random.default_rng(0), traffic.fresh_needed(mix))
    s1 = traffic.make(mix, ds, np.random.default_rng(9), "cpu")
    s2 = traffic.make(mix, ds, np.random.default_rng(9), "cpu")
    assert (s1.read_keys == s2.read_keys).all()
    assert s1.ops(0) == (1900, 100)
    assert s1.read_keys.shape == (3, 1900)
    lens = s1.lengths
    assert lens.min() >= 1 and lens.max() <= 100 and abs(lens.mean() - 50.5) < 2
    # starts are record keys, asked as successors of start - 1
    assert np.isin(s1.read_keys.numpy() + 1, ds.records).all()
    ins = s1.upd_keys.numpy().ravel()
    assert np.unique(ins).size == ins.size
    assert not np.isin(ins, ds.keys).any()
    assert (s1.upd_pays.numpy().ravel() >= 30_000).all()


def test_mixed_shares():
    mix = {"batch": 1024, "reads": {"op": "search", "keys": {"dist": "uniform"}},
           "updates": {"kind": "mixed", "pct": 10, "insert_share": 0.5},
           "max_steps": 200}
    cfg = {"data": {"kind": "uniform_draws", "draws": 1000, "key_max": 5000}}
    ds = data.make(cfg, np.random.default_rng(0))
    s = traffic.make(mix, ds, np.random.default_rng(2), "cpu")
    kinds = s.upd_kinds.numpy()
    assert ((kinds == 1).sum(1) == 51).all() and ((kinds == 2).sum(1) == 51).all()
    # the rows move from step to step
    assert (kinds[0] != kinds[1]).any()
    assert abs((kinds[:, :512] != 0).mean() - 0.0996) < 0.01
    assert sum(s.ops(i)[0] + s.ops(i)[1] for i in range(200)) == 200 * 1024
