"""The plain reference against a brute-force Python dict."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference.sorted_index import SortedIndex


def _brute(d, kinds, keys, pays):
    out = []
    for kd, k, p in zip(kinds.tolist(), keys.tolist(), pays.tolist()):
        if kd == 1:
            out.append(k not in d)
            d.setdefault(k, p)
        elif kd == 2:
            out.append(k in d)
            d.pop(k, None)
        else:
            out.append(False)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_reference_equals_a_dict(seed):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 60, 25))
    pays = rng.integers(0, 1000, keys.size)
    d = dict(zip(keys.tolist(), pays.tolist()))
    ref = SortedIndex(keys, pays)
    for _ in range(30):
        b = int(rng.integers(1, 24))
        # few distinct keys: most batches update some key twice
        kinds = rng.integers(0, 3, b)
        ks = rng.integers(1, 12, b) * 5
        ps = rng.integers(0, 1000, b)
        q = rng.integers(0, 64, 16)
        found, pay = ref.lookup(q)
        assert found.tolist() == [int(x) in d for x in q]
        assert pay.tolist() == [d.get(int(x), -1) for x in q]
        assert ref.search(q).tolist() == found.tolist()
        sk, sp, sn = ref.successor_k(q, 4)
        live = sorted(d)
        for j, x in enumerate(q.tolist()):
            want = [y for y in live if y > x][:4]
            assert int(sn[j]) == len(want)
            assert sk[j].tolist() == want + [0] * (4 - len(want))
            assert sp[j].tolist() == [d[y] for y in want] + [0] * (4 - len(want))
        assert ref.apply(kinds, ks, ps).tolist() == _brute(d, kinds, ks, ps)
        rk, rp = ref.items()
        assert rk.tolist() == sorted(d)
        assert rp.tolist() == [d[k] for k in sorted(d)]


def test_reference_empty_and_twice_in_a_batch():
    ref = SortedIndex(np.zeros(0, np.int64))
    assert ref.search([1, 2]).tolist() == [False, False]
    res = ref.apply([1, 1, 2, 2, 1], [7, 7, 7, 7, 7], [1, 2, 3, 4, 5])
    assert res.tolist() == [True, False, True, False, True]
    assert ref.lookup([7])[1].tolist() == [5]


def test_lower_precision_control_differs():
    rng = np.random.default_rng(3)
    # as dense as 4,000,000 keys over the int32 domain: a float32 step
    # (128 at 2**30) holds one key in four
    keys = np.unique(rng.integers(2**30, 2**30 + 5000 * 512, 5000))
    exact = SortedIndex(keys, np.arange(keys.size))
    low = SortedIndex(keys, np.arange(keys.size), key_dtype=torch.float32)
    q = rng.integers(2**30, 2**30 + 5000 * 512, 4000)
    q[:2000] = keys[:2000]
    a, b = exact.lookup(q), low.lookup(q)
    assert bool(((a[0] != b[0]) | (a[1] != b[1])).any())
