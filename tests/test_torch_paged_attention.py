"""PyTorch port: the plain version of the paged decode-attention kernel
(`repro_torch.kernels.ref.ref_paged_decode_attention`, what the wrapper
runs for CPU tensors) against the JAX Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it, on the same numpy inputs.

Tolerances: 2e-5 in float32 (the two sum the scores and the weighted
values in other orders: one pass over the gathered pages here, page by
page there) and 1e-2 in bfloat16 (inputs are the same bf16 values; the
output is rounded to bf16, whose step at |x| in [1, 2) is 2**-7, so a
float32 difference of a few ulps can flip one rounding).  The JAX side
runs once per module.  The CUDA kernel itself is held against this plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.delta_paged_attention import paged_decode_attention as j_pda
from repro.kernels.ref import ref_paged_decode_attention as j_ref
from repro_torch.kernels import ref as TREF
from repro_torch.kernels.delta_paged_attention import paged_decode_attention

SHAPES = [
    (2, 4, 2, 64, 8, 4),
    (3, 8, 1, 128, 16, 3),
    (1, 2, 2, 32, 4, 6),
    (4, 8, 8, 64, 8, 2),   # MHA (G=1)
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _inputs(b, qh, kvh, d, ps, maxp):
    """tests/test_kernels.py::test_paged_attention_kernel_vs_ref's inputs."""
    rng = np.random.default_rng(b * 100 + qh)
    npages = b * maxp + 3
    q = rng.standard_normal((b, qh, d)).astype(np.float32)
    kp = rng.standard_normal((npages, ps, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((npages, ps, kvh, d)).astype(np.float32)
    lens = rng.integers(1, maxp * ps + 1, size=b).astype(np.int32)
    bt = np.full((b, maxp), -1, np.int32)
    perm = rng.permutation(npages)
    c = 0
    for i in range(b):
        for j in range(-(-int(lens[i]) // ps)):
            bt[i, j] = perm[c]
            c += 1
    return q, kp, vp, bt, lens


def _garbage_inputs():
    """tests/test_kernels.py::test_paged_attention_ignores_garbage_pages."""
    rng = np.random.default_rng(0)
    b, qh, kvh, d, ps = 2, 4, 2, 32, 8
    q = rng.standard_normal((b, qh, d)).astype(np.float32)
    kp = rng.standard_normal((10, ps, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((10, ps, kvh, d)).astype(np.float32)
    lens = np.asarray([9, 17], np.int32)
    bt = np.asarray([[4, 5, -1], [6, 7, 8]], np.int32)
    kp2, vp2 = kp.copy(), vp.copy()
    for g in (0, 1, 2, 3, 9):   # unreferenced pages scrambled
        kp2[g] = 1e3
        vp2[g] = -1e3
    return (q, kp, vp, bt, lens), (q, kp2, vp2, bt, lens)


def _empty_inputs():
    """A batch whose second sequence has length 0 (no page mapped)."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    kp = rng.standard_normal((4, 4, 2, 16)).astype(np.float32)
    vp = rng.standard_normal((4, 4, 2, 16)).astype(np.float32)
    bt = np.asarray([[2, 0], [-1, -1]], np.int32)
    return q, kp, vp, bt, np.asarray([5, 0], np.int32)


def _jax(fn, args, dtype=jnp.float32):
    q, kp, vp, bt, lens = args
    out = fn(jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
             jnp.asarray(vp, dtype), jnp.asarray(bt), jnp.asarray(lens))
    return np.asarray(out, np.float32)


def _port(args, dtype=torch.float32):
    q, kp, vp, bt, lens = args
    out = paged_decode_attention(
        torch.as_tensor(q).to(dtype), torch.as_tensor(kp).to(dtype),
        torch.as_tensor(vp).to(dtype), torch.as_tensor(bt),
        torch.as_tensor(lens))
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX output this module compares with, computed once."""
    res = {}
    for shape in SHAPES:
        for name, (jdt, _, _) in DTYPES.items():
            res[shape, name] = _jax(j_pda, _inputs(*shape), jdt)
    clean, scrambled = _garbage_inputs()
    res["garbage"] = (_jax(j_pda, clean), _jax(j_pda, scrambled))
    res["empty"] = (_jax(j_pda, _empty_inputs()), _jax(j_ref, _empty_inputs()))
    return res


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_equals_jax_kernel(jax_side, shape, dtype):
    _, tdt, tol = DTYPES[dtype]
    err = np.abs(_port(_inputs(*shape), tdt) - jax_side[shape, dtype]).max()
    assert err < tol, (shape, dtype, err)


def test_plain_ignores_garbage_pages(jax_side):
    """Pages a sequence's block table does not reference never leak in;
    both runs equal the JAX kernel's."""
    clean, scrambled = _garbage_inputs()
    a, b = _port(clean), _port(scrambled)
    np.testing.assert_array_equal(a, b)
    for got, want in zip((a, b), jax_side["garbage"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_empty_sequence_gives_zero_like_the_kernel(jax_side):
    """seq_len == 0: the JAX Pallas kernel and the port return 0 (acc /
    max(l, 1e-30) with nothing accumulated); the JAX ref returns NaN (a
    softmax over an all -inf row).  The port follows the kernel."""
    kern, jref = jax_side["empty"]
    got = _port(_empty_inputs())
    assert (kern[1] == 0).all() and (got[1] == 0).all()
    assert np.isnan(jref[1]).all()
    np.testing.assert_allclose(got[0], kern[0], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got[0], jref[0], rtol=0, atol=2e-5)


def test_wrapper_on_cpu_runs_the_plain_version():
    """A CPU tensor goes to the plain version (counted in ``calls``) and
    never counts a kernel launch."""
    launches = paged_decode_attention.launches
    calls = TREF.ref_paged_decode_attention.calls
    _port(_inputs(*SHAPES[0]))
    assert TREF.ref_paged_decode_attention.calls == calls + 1
    assert paged_decode_attention.launches == launches


def test_wrapper_rejects_bad_inputs():
    q, kp, vp, bt, lens = (torch.as_tensor(x) for x in _inputs(*SHAPES[0]))
    with pytest.raises(TypeError):
        paged_decode_attention(q, kp.to(torch.bfloat16), vp, bt, lens)
    with pytest.raises(TypeError):
        paged_decode_attention(q, kp, vp, bt.long(), lens)
    with pytest.raises(ValueError):
        paged_decode_attention(q, kp, vp, bt[:1], lens)
    with pytest.raises(ValueError):
        paged_decode_attention(q[:, :3], kp, vp, bt, lens)   # 3 % 2 heads
