"""PyTorch port: the ΔTree-paged serve path equals the JAX package.

The JAX pager packs int64 values, so its side runs with x64 in a
subprocess, once per test run (`_torch_parity.jax_npz`: one subprocess per
scenario, shared by the xdist workers), and passes back as ``.npz`` the
smoke model's weights, every token, each decode step's block table and
logits, the index arena arrays, the pager stats and the free list.  The
port runs the same scenarios on the CPU from the same weights:

- the pager's map semantics (`tests/test_serving.py::
  test_pager_map_semantics`), the arena arrays equal after every allocate
  and free;
- ``ServeEngine`` on the static trace of ``test_engine_matches_dense_decode``:
  the same tokens, block tables, free list and pager stats, each step's
  logits within 1e-5 (float32 smoke config; the products sum in another
  order than XLA's);
- the port's engine against the port's dense-cache decode;
- the sharded pager (a DeltaForest index) on the script of
  `tests/test_forest.py::test_sharded_pager_x64_8_devices`, on one device:
  block tables, stats, free list and every shard's arena equal after every
  op; and one sequence whose ascending blocks chain ΔNodes deeper than the
  reference's walk cap still resolves every block.

The scheduler under churn is in `test_torch_serve_sched.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import make_index
from repro_torch.configs import get_smoke_config
from repro_torch.core import deltatree as TDT
from repro_torch.models.transformer import Transformer
from repro_torch.serve import decode as TD
from repro_torch.serving import PagerConfig, ServeEngine
from repro_torch.serving.pager import DeltaPager

from _torch_parity import (
    SERVE_PRELUDE,
    SHARDED_PAGER,
    check_pager,
    check_sharded_pager,
    few_jax_executables,  # noqa: F401  (autouse)
    jax_npz,
    jax_sharded,
    prefixed,
    run_sharded_script,
    serve_model,
    tree_depth,
)

LOGIT_TOL = 1e-5   # float32 smoke config; XLA and torch sum in other orders
PAGER = dict(num_pages=128, page_size=4, max_blocks=64,
             tree_height=4)
STATIC = dict(num_pages=64, page_size=4, max_blocks=64,
              tree_height=4)
# ascending block keys in batches of DEEP_BATCH chain ΔNodes deeper than
# the lockstep walk's geometry-derived round cap (14 here)
DEEP = dict(num_pages=128, page_size=4, max_blocks=64, tree_height=4,
            engine="lockstep")
DEEP_SEQS, DEEP_BLOCKS, DEEP_BATCH = 4, 24, 16

_JAX_PAGER = r'''
from repro.serving.pager import DeltaPager, PagerConfig

# the pager's map semantics (tests/test_serving.py)
pg = DeltaPager(PagerConfig(**PAGER))
ops = [("alloc", 0, 3), ("alloc", 1, 2), ("bt", [0, 1], 4), ("alloc", 0, 2),
       ("bt", [0], 5), ("free", 0, 0), ("bt", [0, 1], 4), ("free", 1, 0)]
for i, (op, a, n) in enumerate(ops):
    if op == "alloc":
        rec[f"pager/{i}/pages"] = np.asarray(pg.allocate(a, n), np.int64)
    elif op == "free":
        pg.free_seq(a)
    else:
        rec[f"pager/{i}/bt"] = np.asarray(pg.block_tables(a, n))
    pager_state(f"pager/{i}", pg)

# the lockstep walk's round cap under ascending block keys
pg = DeltaPager(PagerConfig(**DEEP))
for sid in range(DEEP_SEQS):
    pg.stage_allocate(sid, DEEP_BLOCKS)
staged = list(pg._staged)
pg._staged.clear()
for i in range(0, len(staged), DEEP_BATCH):
    pg._staged.extend(staged[i:i + DEEP_BATCH])
    pg.apply_staged()
rec["deep/bt"] = np.asarray(pg.block_tables(list(range(DEEP_SEQS)),
                                            DEEP_BLOCKS))
rec["deep/live"] = np.asarray(len(pg.index.live_items()))
pager_state("deep", pg)
'''

_JAX_ENGINE = r'''
from repro.serving import PagerConfig, ServeEngine
import repro.serve.decode as D

# ServeEngine on the static trace of test_engine_matches_dense_decode
logits = []
step_fn = D.paged_decode_step
def recording_step(*a, **k):
    out = step_fn(*a, **k)
    logits.append(np.asarray(out[0]))
    return out
D.paged_decode_step = recording_step
rng = np.random.default_rng(7)
eng = ServeEngine(cfg, params, PagerConfig(**STATIC), max_batch=4)
tables = []
bt_fn = eng.pager.block_tables
eng.pager.block_tables = lambda s, n: tables.append(bt_fn(s, n)) or tables[-1]
prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
           for n in (5, 9, 3)]
sids = [eng.submit(p, max_new=6) for p in prompts]
for _ in range(8):
    eng.step()
for sid in sids:
    rec[f"engine/tokens/{sid}"] = np.asarray(eng.active[sid].out, np.int64)
for i, (t, l) in enumerate(zip(tables, logits)):
    rec[f"engine/bt/{i}"] = t
    rec[f"engine/logits/{i}"] = l
pager_state("engine", eng.pager)
'''


def _jax(tmp_path_factory, name: str, body: str) -> dict:
    consts = dict(PAGER=PAGER, STATIC=STATIC, DEEP=DEEP, DEEP_SEQS=DEEP_SEQS,
                  DEEP_BLOCKS=DEEP_BLOCKS, DEEP_BATCH=DEEP_BATCH)
    head = "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    return jax_npz(tmp_path_factory, f"torch_serving_{name}",
                   head + SERVE_PRELUDE + body)


@pytest.fixture(scope="module")
def jax_pager(tmp_path_factory):
    return _jax(tmp_path_factory, "pager", _JAX_PAGER)


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    return _jax(tmp_path_factory, "engine", _JAX_ENGINE)


# ---------------------------------------------------------------- pager ---


@pytest.mark.parametrize("engine", ["scalar", "lockstep"])
def test_pager_map_semantics_equal_jax(jax_pager, engine):
    """allocate / block_tables / grow / free_seq as in the JAX test: pages,
    tables, stats, free list and the 16 arena arrays equal after every op."""
    rec = jax_pager
    pg = DeltaPager(PagerConfig(**PAGER, engine=engine), device="cpu")
    ops = [("alloc", 0, 3), ("alloc", 1, 2), ("bt", [0, 1], 4),
           ("alloc", 0, 2), ("bt", [0], 5), ("free", 0, 0),
           ("bt", [0, 1], 4), ("free", 1, 0)]
    for i, (op, a, n) in enumerate(ops):
        if op == "alloc":
            assert pg.allocate(a, n) == rec[f"pager/{i}/pages"].tolist()
        elif op == "free":
            pg.free_seq(a)
        else:
            bt = pg.block_tables(a, n)
            assert bt.dtype == torch.int32 and bt.device.type == "cpu"
            np.testing.assert_array_equal(bt.numpy(), rec[f"pager/{i}/bt"])
        check_pager(rec, f"pager/{i}", pg)
    assert sorted(pg.free_pages) == list(range(PAGER["num_pages"]))


@pytest.mark.parametrize("cap", ["reference", "port"])
def test_pager_deep_tree_walk_cap(jax_pager, cap):
    """A reference fault: ascending block keys chain ΔNodes deeper than
    the lockstep walk's geometry-derived round cap (14 here), so lookups
    past it miss and update positions land at the root — the JAX pager
    loses items without an error.  At that cap the port equals it bit for
    bit; the port's pager caps the walks at ``max_dnodes`` (no arena is
    deeper), finds every block and keeps every item."""
    rec = jax_pager
    n = DEEP_SEQS * DEEP_BLOCKS
    cfg = PagerConfig(**DEEP)
    index = None
    if cap == "reference":
        index = make_index("deltatree", device="cpu", cfg=dataclasses.replace(
            cfg.tree_config, walk_rounds=0))
        assert index.cfg.walk_round_cap == 14
    pg = DeltaPager(cfg, index, device="cpu")
    for sid in range(DEEP_SEQS):
        pg.stage_allocate(sid, DEEP_BLOCKS)
    staged = list(pg._staged)
    pg._staged.clear()
    for i in range(0, len(staged), DEEP_BATCH):
        pg._staged.extend(staged[i:i + DEEP_BATCH])
        pg.apply_staged()
    bt = pg.block_tables(list(range(DEEP_SEQS)), DEEP_BLOCKS).numpy()
    live = len(pg.index.live_items())
    assert int((rec["deep/bt"] < 0).sum()) > 0 and int(rec["deep/live"]) < n
    if cap == "reference":
        np.testing.assert_array_equal(bt, rec["deep/bt"])
        assert live == int(rec["deep/live"])
        check_pager(rec, "deep", pg)
    else:
        assert (bt >= 0).all() and live == n
        assert sorted(bt.reshape(-1).tolist()) == sorted(
            p for ps in pg._staged_pages.values() for p in ps)


def test_pager_staged_protocol_equals_immediate():
    """The staged protocol (stage_allocate / stage_free / apply_staged)
    leaves the same mappings, free list and arena as the immediate one,
    and an admitted-then-freed sequence annihilates in the combine pass."""
    imm = DeltaPager(PagerConfig(**PAGER), device="cpu")
    stg = DeltaPager(PagerConfig(**PAGER), device="cpu")
    for sid, n in ((0, 3), (1, 2), (2, 4)):
        assert imm.allocate(sid, n) == stg.stage_allocate(sid, n)
    stg.stage_free(2)                    # inserts and deletes annihilate
    imm.free_seq(2)
    applied = stg.apply_staged()
    assert applied["combined"] == 8 and applied["applied"] == 5
    assert imm.free_pages == stg.free_pages
    np.testing.assert_array_equal(imm.block_tables([0, 1, 2], 5).numpy(),
                                  stg.block_tables([0, 1, 2], 5).numpy())
    assert sorted(TDT.live_items(imm.index.cfg, imm.index.state)) == \
        sorted(TDT.live_items(stg.index.cfg, stg.index.state))


# --------------------------------------------------------------- engine ---


def _static_prompts(cfg):
    rng = np.random.default_rng(7)
    return [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
            for n in (5, 9, 3)]


@pytest.mark.parametrize("engine", ["scalar", "lockstep"])
def test_engine_static_trace_equals_jax(jax_engine, monkeypatch, engine):
    """ServeEngine on test_engine_matches_dense_decode's trace: tokens,
    each step's block table, free list and pager stats equal JAX's, each
    step's logits within ``LOGIT_TOL``."""
    rec = jax_engine
    model = serve_model(rec)
    cfg = model.cfg
    logits = []
    step_fn = TD.paged_decode_step

    def recording_step(*a, **k):
        out = step_fn(*a, **k)
        logits.append(out[0].numpy())
        return out

    monkeypatch.setattr(TD, "paged_decode_step", recording_step)
    eng = ServeEngine(cfg, model, PagerConfig(**STATIC, engine=engine),
                      max_batch=4)
    tables = []
    bt_fn = eng.pager.block_tables
    eng.pager.block_tables = lambda s, n: tables.append(bt_fn(s, n)) \
        or tables[-1]
    sids = [eng.submit(p, max_new=6) for p in _static_prompts(cfg)]
    for _ in range(8):
        eng.step()
    for sid in sids:
        assert eng.active[sid].out == rec[f"engine/tokens/{sid}"].tolist()
    assert len(tables) == len(logits) == len(prefixed(rec, "engine/bt"))
    for i, (t, lg) in enumerate(zip(tables, logits)):
        np.testing.assert_array_equal(t.numpy(), rec[f"engine/bt/{i}"])
        np.testing.assert_allclose(lg, rec[f"engine/logits/{i}"], rtol=0,
                                   atol=LOGIT_TOL, err_msg=f"step {i}")
    check_pager(rec, "engine", eng.pager)
    assert len(eng.pager.free_pages) == STATIC["num_pages"]


def _dense_tokens(model, prompt, n_new: int) -> list[int]:
    """The port's dense-cache decode (`Transformer.prefill` +
    `decode_step`): greedy tokens of one request."""
    caches = model.init_caches(1, len(prompt) + n_new)
    logits, caches = model.prefill(torch.as_tensor(prompt)[None], caches)
    toks = [int(logits[0, -1].argmax())]
    ln = len(prompt)
    while len(toks) < n_new:
        lg, caches = model.decode_step(
            torch.tensor([[toks[-1]]], dtype=torch.int32), caches,
            torch.tensor([ln], dtype=torch.int32))
        toks.append(int(lg[0, 0].argmax()))
        ln += 1
    return toks


def test_engine_matches_port_dense_decode():
    """The port's ServeEngine equals the port's dense-cache decode token
    for token (the port's counterpart of test_engine_matches_dense_decode),
    and every page returns to the free list."""
    cfg = get_smoke_config("granite_8b")
    model = Transformer(cfg, device="cpu", seed=3)
    eng = ServeEngine(cfg, model, PagerConfig(**STATIC, engine="lockstep"),
                      max_batch=4)
    prompts = _static_prompts(cfg)
    sids = [eng.submit(p, max_new=6) for p in prompts]
    for _ in range(8):
        eng.step()
    for p, sid in zip(prompts, sids):
        assert eng.active[sid].out == _dense_tokens(model, p, 6), sid
    assert len(eng.pager.free_pages) == STATIC["num_pages"]
    assert eng.pager.stats["searches"] > 0




# -------------------------------------------------------- sharded pager ---


@pytest.fixture(scope="module")
def jax_sharded_rec(tmp_path_factory):
    return jax_sharded(tmp_path_factory)


@pytest.mark.parametrize("engine", ["scalar", "lockstep"])
def test_sharded_pager_equals_jax(jax_sharded_rec, engine):
    """The JAX sharded pager's script (allocate, block tables, grow, free)
    on one device: block tables, stats, free list and every shard's arena
    equal JAX's after every op (JAX reads with its scalar engine)."""
    from repro_torch.serving import ShardedDeltaPager, ShardedPagerConfig

    rec = jax_sharded_rec
    pc = ShardedPagerConfig(**SHARDED_PAGER, engine=engine)
    assert pc.forest_config.key_max == 4 * pc.band == 4 * 8 * 64
    pg = ShardedDeltaPager(pc, device="cpu")
    tables = run_sharded_script(
        pg, lambda i, p: check_sharded_pager(rec, f"script/{i}", p))
    assert len(tables) == 3
    for i, t in enumerate(tables):
        np.testing.assert_array_equal(t, rec[f"script/tables/{i}"],
                                      err_msg=str(i))
    assert sorted(pg.free_pages) == list(range(SHARDED_PAGER["num_pages"]))


def test_sharded_pager_deep_sequence_resolves():
    """One sequence's ascending blocks, inserted 16 at a time, chain
    ΔNodes in its shard far deeper than the walk cap a balanced arena of
    that size would get (14): the forest's walks are capped at the
    per-shard ``max_dnodes``, so every block resolves and every item
    stays."""
    from repro_torch.distributed import forest as TF
    from repro_torch.kernels.ops import walk_round_cap
    from repro_torch.serving import ShardedDeltaPager, ShardedPagerConfig

    pc = ShardedPagerConfig(num_pages=256, page_size=4, max_seqs=8,
                            max_blocks=128, tree_height=4, num_shards=4,
                            engine="lockstep")
    tcfg = pc.forest_config.tree
    assert walk_round_cap(tcfg.height, tcfg.max_dnodes) == 14
    assert tcfg.walk_round_cap == tcfg.max_dnodes == 64
    pg = ShardedDeltaPager(pc, device="cpu")
    pages = []
    for _ in range(6):
        pages += pg.allocate(0, 16)
    assert tree_depth(TF.shard_tree(pg.index.state, 0)) > 14
    bt = pg.block_tables([0], 96).numpy()
    np.testing.assert_array_equal(bt[0], pages)
    assert len(pg.index.live_items()) == 96
    pg.free_seq(0)
    assert len(pg.index.live_items()) == 0
