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
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``); its
split plan and the limits the wrapper holds for it are tested here.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.delta_paged_attention import paged_decode_attention as j_pda
from repro.kernels.ref import ref_paged_decode_attention as j_ref
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import delta_paged_attention as TPA
from repro_torch.kernels.delta_paged_attention import paged_decode_attention

SHAPES = [
    (2, 4, 2, 64, 8, 4),
    (3, 8, 1, 128, 16, 3),
    (1, 2, 2, 32, 4, 6),
    (4, 8, 8, 64, 8, 2),   # MHA (G=1)
    (3, 6, 2, 64, 8, 3),   # G=3 (StarCoder2's smoke config)
    (2, 12, 1, 64, 8, 4),  # G=12 (StarCoder2-15B): two sub-groups of 6
    (2, 16, 1, 32, 4, 5),  # G=16: two sub-groups of 8
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
    # the CUDA kernel's limits, held on the CPU too: a K/V row of D *
    # element size bytes must be a power of two from 32 to 512 ...
    for d in (4, 48, 256):                 # 16, 192 and 1024 bytes in f32
        with pytest.raises(ValueError, match="K/V row"):
            paged_decode_attention(q.new_zeros(2, 4, d),
                                   kp.new_zeros(kp.shape[:3] + (d,)),
                                   vp.new_zeros(vp.shape[:3] + (d,)), bt, lens)
    # ... any number of query heads a KV head (a group of more than 8
    # splits into sub-groups of at most 8, one block each) ...
    g9 = torch.randn(2, 18, 64, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(
        paged_decode_attention(g9, kp, vp, bt, lens).numpy(),
        TREF.ref_paged_decode_attention(g9, kp, vp, bt, lens).numpy())
    assert TPA.subgroups(9) == (2, 5) and TPA.subgroups(8) == (1, 8)
    # ... a block's rings of pages within 227 KB of shared memory ...
    big = kp.new_zeros(kp.shape[0], 64, 2, 128)
    with pytest.raises(ValueError, match="shared"):
        paged_decode_attention(q.new_zeros(2, 4, 128), big, big, bt, lens)
    # ... and q, k_pages and v_pages 16-byte aligned
    off = torch.zeros(kp.numel() + 1)[1:].view(kp.shape)
    with pytest.raises(ValueError, match="aligned"):
        paged_decode_attention(q, off, vp, bt, lens)


# (B, KVH, MAXP, SMs): the served batch (8 lanes, ~1 k tokens, Granite's 8
# KV heads), decode_32k's batch at 4096 tokens, one 32 k context, tiny
# shapes, MAXP = 1, and a smaller card
PLANS = [(8, 8, 97, 132), (64, 8, 256, 132), (1, 8, 2048, 132),
         (2, 2, 3, 132), (1, 1, 5, 132), (4, 8, 1, 132), (64, 8, 1, 132),
         (3, 8, 700, 16)]


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "x".join(map(str, p)))
def test_split_plan_covers_every_page_once(plan):
    """Every logical page below MAXP lies in exactly one chunk, no chunk is
    empty of logical pages, at least one split; the plan reads shapes and
    the SM count only, so no length is read on the host."""
    b, kvh, maxp, sms = plan
    splits, pps = TPA.split_plan(b, kvh, maxp, sms)
    assert splits >= 1 and pps >= 1
    owner = np.full(maxp, -1)
    for s in range(splits):
        chunk = np.arange(s * pps, min((s + 1) * pps, maxp))
        assert chunk.size > 0, (s, splits, pps)
        assert (owner[chunk] == -1).all()
        owner[chunk] = s
    assert (owner >= 0).all()
    assert list(inspect.signature(TPA.split_plan).parameters) == [
        "b", "kvh", "maxp", "sm_count"]
    assert TPA.split_plan(b, kvh, maxp, sms) == (splits, pps)
    # a chunk gives each warp at least its share of pages, unless MAXP
    # itself is shorter; the grid fills the card twice where pages allow
    assert pps >= min(maxp, TPA.WARPS * TPA.MIN_PAGES_PER_WARP)
    if b * kvh * (maxp // (TPA.WARPS * TPA.MIN_PAGES_PER_WARP)) \
            >= TPA.BLOCKS_PER_SM * sms:
        assert b * kvh * splits >= 2 * sms


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(32, 8, 128, 16), (4, 2, 16, 4),
                                   (48, 4, 128, 16), (64, 8, 128, 16),
                                   (16, 8, 128, 16), (16, 1, 128, 16)],
                         ids=["granite_8b", "granite_smoke", "starcoder2_15b",
                              "qwen1_5_110b", "internvl2_2b", "g16"])
def test_kernel_limits_admit_the_served_shapes(shape, dtype):
    """The shapes the serve path runs (every served config's heads, G = 1
    to 12, G = 16 and the smoke config, both dtypes) pass the kernel's
    limits; a bf16 block at D = 128 and G <= 4 fits two to an SM."""
    qh, kvh, d, ps = shape
    q = torch.zeros(2, qh, d, dtype=dtype)
    kp = torch.zeros(6, ps, kvh, d, dtype=dtype)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.full((2,), 2, dtype=torch.int32)
    out = paged_decode_attention(q, kp, kp, bt, lens)
    assert out.shape == q.shape
    smem = TPA.smem_bytes(ps, d, qh // kvh, q.element_size())
    assert smem <= TPA.SMEM_LIMIT
    if d == 128 and dtype == torch.bfloat16 and qh // kvh <= 4:
        assert 2 * smem <= TPA.SMEM_LIMIT
