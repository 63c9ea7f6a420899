"""PyTorch port: the vEB layout tables equal the JAX package's, exactly."""

import numpy as np
import pytest

from repro.core import layout as JL
from repro_torch.core import layout as TL


@pytest.mark.parametrize("h", range(2, 11))
def test_layout_tables_equal(h):
    assert TL.veb_order(h) == JL.veb_order(h)
    for fn in (TL.veb_pos_table, TL.veb_inverse_table):
        a, b = fn(h), getattr(JL, fn.__name__)(h)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ta, tb = TL.rebuild_tables(h), JL.rebuild_tables(h)
    assert set(ta) == set(tb)
    for name in ta:
        np.testing.assert_array_equal(ta[name], tb[name], err_msg=name)
    assert (TL.num_nodes(h), TL.leaf_capacity(h), TL.bottom_first(h)) == (
        JL.num_nodes(h), JL.leaf_capacity(h), JL.bottom_first(h))


@pytest.mark.parametrize("dtype,route_left", [
    (np.int32, None), (np.int64, np.int64(1) << 62)])
@pytest.mark.parametrize("force_bottom", [False, True])
def test_rebuild_values_equal(dtype, route_left, force_bottom):
    rng = np.random.default_rng(7)
    for h in (3, 5, 7):
        for m in (0, 1, 2, 3, 2 ** (h - 2) + 1, 2 ** (h - 1)):
            vals = np.sort(rng.choice(10_000, size=max(m, 1), replace=False)
                           + 1).astype(dtype)
            a = TL.rebuild_values_np(h, vals, m, force_bottom, dtype,
                                     route_left)
            b = JL.rebuild_values_np(h, vals, m, force_bottom, dtype,
                                     route_left)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f"h={h} m={m}")


def test_reserved_constants_equal():
    assert TL.EMPTY == JL.EMPTY and TL.EMPTY.dtype == JL.EMPTY.dtype
    assert TL.ROUTE_LEFT == JL.ROUTE_LEFT
    assert (TL.KEY_MIN, TL.KEY_MAX) == (JL.KEY_MIN, JL.KEY_MAX)
