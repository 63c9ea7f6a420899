"""PyTorch port: ``kernels/autotune.py`` and the walks' ``q_tile`` (the CUDA
kernels' block size).

* The cache reads, merges and degrades on the same files exactly as the
  JAX package's (``repro.kernels.autotune``): a missing file, corrupt
  files, a merge, no cache configured; the ``_key`` strings are equal.
* ``ops.default_q_tile`` resolves a ``REPRO_TORCH_QTILE`` pin, then the
  ``REPRO_TORCH_AUTOTUNE`` cache, then ``BAKED``, then 64; a pin, a cache
  entry, a table entry or an explicit size that is not a built block size
  raises; the JAX package's variables are not read.
* ``TreeConfig(q_tile=...)`` reaches the walk wrappers through the engine
  and ``ops.delta_walk`` (fused and per-round), with the same bits.
* ``sweep_height`` raises on the CPU, where no block size reaches a
  kernel.
"""

import json

import numpy as np
import pytest

from repro.kernels import autotune as JAT
from repro_torch.api import make_index
from repro_torch.kernels import autotune as TAT
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import veb_search as VS

from _torch_parity import few_jax_executables  # noqa: F401  (autouse)


@pytest.fixture
def clean_env(monkeypatch):
    for var in (TAT.ENV_CACHE, JAT.ENV_CACHE, "REPRO_TORCH_QTILE",
                "REPRO_PALLAS_QTILE"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("height", [5, 7, 22])
@pytest.mark.parametrize("compiled", [True, False])
@pytest.mark.parametrize("bits", [32, 64])
def test_keys_equal(height, compiled, bits):
    assert (TAT._key(height, compiled, bits)
            == JAT._key(height, compiled, bits))


CORRUPT = ("{not json", '{"7/compiled/32": "x"}', '{"7/compiled/32": null}',
           "")


@pytest.mark.parametrize("text", CORRUPT)
def test_corrupt_or_missing_file_reads_empty(tmp_path, clean_env, text):
    """A file that does not parse as a table reads as an empty table in
    both packages (the autotuner never makes a walk fail), and so does a
    missing file; a save over a corrupt file starts afresh alike."""
    missing = tmp_path / "none.json"
    assert TAT.load_cache(str(missing)) == JAT.load_cache(str(missing)) == {}
    bad = tmp_path / "bad.json"
    bad.write_text(text)
    assert TAT.load_cache(str(bad)) == JAT.load_cache(str(bad)) == {}
    for mod, name in ((TAT, "t.json"), (JAT, "j.json")):
        path = tmp_path / name
        path.write_text(text)
        assert mod.save_cache({"7/compiled/32": 128}, str(path)) == str(path)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_merge_writes_the_same_file(tmp_path, clean_env):
    """Saves merge into the file (a key saved again is updated) and give
    byte-identical files in both packages; each reads the other's."""
    tables = ({"7/compiled/32": 64, "5/compiled/32": 256},
              {"7/compiled/32": 128, "9/compiled/64": 32},
              {"22/interpret/32": 32})
    files = {}
    for mod, name in ((TAT, "t.json"), (JAT, "j.json")):
        path = str(tmp_path / name)
        for table in tables:
            mod.save_cache(table, path)
        files[mod] = path
    assert (open(files[TAT]).read() == open(files[JAT]).read())
    want = {"5/compiled/32": 256, "7/compiled/32": 128, "9/compiled/64": 32,
            "22/interpret/32": 32}
    assert json.load(open(files[TAT])) == want
    assert TAT.load_cache(files[JAT]) == JAT.load_cache(files[TAT]) == want


def test_no_cache_configured(tmp_path, clean_env):
    """With no cache variable set neither package reads or writes a file;
    each reads its own variable only."""
    assert TAT.cache_path() is None and JAT.cache_path() is None
    assert TAT.save_cache({"7/compiled/32": 128}) is None
    assert JAT.save_cache({"7/compiled/32": 128}) is None
    assert TAT.load_cache() == JAT.load_cache() == {}
    path = tmp_path / "c.json"
    path.write_text('{"7/compiled/32": 128}')
    clean_env.setenv(JAT.ENV_CACHE, str(path))
    assert TAT.cache_path() is None and TAT.load_cache() == {}
    clean_env.setenv(TAT.ENV_CACHE, str(path))
    assert TAT.cache_path() == str(path)
    assert TAT.load_cache() == {"7/compiled/32": 128}


def test_resolution_order(tmp_path, clean_env):
    """A pin, then the cache, then BAKED, then 64, for the card's key
    (compiled) and the CPU's (interpret) apart."""
    assert TAT.BAKED == {} or all(v in VS.BLOCK_SIZES
                                  for v in TAT.BAKED.values())
    clean_env.setattr(TAT, "BAKED", {})
    assert OPS.default_q_tile(7) == VS.DEFAULT_BLOCK == 64
    assert OPS.default_q_tile() == 64
    clean_env.setitem(TAT.BAKED, (7, True, 32), 128)
    assert OPS.default_q_tile(7) == 128
    assert OPS.default_q_tile(7, compiled=False) == 64
    assert OPS.default_q_tile(7, payload_bits=12) == 64
    assert OPS.default_q_tile(9) == 64
    path = tmp_path / "cache.json"
    clean_env.setenv(TAT.ENV_CACHE, str(path))
    TAT.save_cache({TAT._key(7, True, 32): 256, TAT._key(7, False, 64): 32})
    assert OPS.default_q_tile(7) == 256
    assert OPS.default_q_tile(7, payload_bits=12, compiled=False) == 32
    clean_env.setenv("REPRO_PALLAS_QTILE", "512")   # JAX's pin: not read
    assert OPS.default_q_tile(7) == 256
    clean_env.setenv("REPRO_TORCH_QTILE", "32")
    assert OPS.default_q_tile(7) == OPS.default_q_tile() == 32
    assert OPS._resolve_q_tile(128, 7) == 128      # an explicit size wins


@pytest.mark.parametrize("fault", ["pin", "pin_text", "cache", "baked",
                                   "explicit"])
def test_unbuilt_sizes_raise(tmp_path, clean_env, fault):
    """Every origin of a size that no kernel was built for raises, naming
    the origin; so does the walk that would use it, on the CPU too."""
    clean_env.setattr(TAT, "BAKED", {})
    where = {"pin": "REPRO_TORCH_QTILE", "pin_text": "integer",
             "cache": "autotune table", "baked": "autotune table",
             "explicit": "explicit q_tile"}[fault]
    tile = None
    if fault == "pin":
        clean_env.setenv("REPRO_TORCH_QTILE", "48")
    elif fault == "pin_text":
        clean_env.setenv("REPRO_TORCH_QTILE", "sixty-four")
    elif fault == "cache":
        path = tmp_path / "cache.json"
        path.write_text(json.dumps({TAT._key(4, False, 32): 1024}))
        clean_env.setenv(TAT.ENV_CACHE, str(path))
    elif fault == "baked":
        clean_env.setitem(TAT.BAKED, (4, False, 32), 96)
    else:
        tile = 100
    with pytest.raises(ValueError, match=where):
        OPS._resolve_q_tile(tile, 4, compiled=False)
    ix = make_index("deltatree", initial=np.arange(1, 50, dtype=np.int32),
                    height=4, max_dnodes=64, engine="lockstep", device="cpu",
                    q_tile=tile or 0)
    with pytest.raises(ValueError, match=where):
        ix.search(np.arange(1, 9, dtype=np.int32))


@pytest.mark.parametrize("walk_fused", [True, False])
def test_tree_config_q_tile_reaches_the_walk(clean_env, walk_fused):
    """``TreeConfig.q_tile`` (0: resolved) is what the walk wrapper gets,
    fused or per round, and every size reads the same bits."""
    clean_env.setattr(TAT, "BAKED", {})
    name = "veb_walk_fused" if walk_fused else "veb_walk_rows"
    real = getattr(OPS, name)
    seen = []

    def spy(*args, **kw):
        seen.append(kw["q_tile"])
        return real(*args, **kw)

    clean_env.setattr(OPS, name, spy)
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(1, 20_000, 3000)).astype(np.int32)
    q = rng.integers(0, 21_000, 512).astype(np.int32)
    results = []
    for tile in (0, *VS.BLOCK_SIZES):
        ix = make_index("deltatree", initial=keys, height=5, max_dnodes=2048,
                        engine="lockstep", walk_fused=walk_fused,
                        device="cpu", q_tile=tile)
        seen.clear()
        found, hops = ix.search(q)
        sf, succ = ix.successor(q)
        assert seen and set(seen) == {tile or VS.DEFAULT_BLOCK}
        results.append([x.numpy() for x in (found, hops, sf, succ)])
    assert int(results[0][1].max()) >= 2
    np.testing.assert_array_equal(results[0][0], np.isin(q, keys))
    for other in results[1:]:
        for a, b in zip(results[0], other):
            np.testing.assert_array_equal(a, b)


def test_sweep_height_needs_the_card():
    with pytest.raises(RuntimeError, match="no block size reaches a kernel"):
        TAT.sweep_height(5, device="cpu")
    assert TAT.CANDIDATES == VS.BLOCK_SIZES
