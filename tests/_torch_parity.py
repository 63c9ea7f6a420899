"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py):
carry a JAX ``DeltaTree`` and its ``TreeConfig`` over to the port, and
compare trees array by array.  Both packages get the same numpy inputs."""

from __future__ import annotations

import dataclasses

import numpy as np


def port_cfg(jcfg):
    """The port's TreeConfig with every field of the JAX one."""
    from repro_torch.core.deltatree import TreeConfig

    return TreeConfig(**dataclasses.asdict(jcfg))


def jax_arrays(jt) -> dict:
    return {k: np.asarray(v) for k, v in jt._asdict().items()}


def to_port(jcfg, jt, device="cpu"):
    """(port cfg, port tree) holding exactly the JAX tree's state."""
    from repro_torch.core.deltatree import from_numpy

    cfg = port_cfg(jcfg)
    return cfg, from_numpy(cfg, jax_arrays(jt), device)


def assert_trees_equal(jt, tt, where="") -> None:
    """All 16 arena arrays equal, dtypes and shapes included.  ``jt`` is a
    JAX tree or its arrays as a dict of numpy arrays (as a subprocess
    passes them back)."""
    from repro_torch.core.deltatree import to_numpy

    a = jt if isinstance(jt, dict) else jax_arrays(jt)
    b = to_numpy(tt)
    assert set(a) == set(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, (where, name)
        assert a[name].shape == b[name].shape, (where, name)
        np.testing.assert_array_equal(a[name], b[name],
                                      err_msg=f"{where}: {name}")


DEEP_KEYS = 600    # chip_smoke.py's DEEP_KEYS


def deep_tree(payload_bits: int, n_keys: int = DEEP_KEYS):
    """(cfg, port tree on the CPU): height 3 (four leaves a ΔNode) after
    ``n_keys`` ascending inserts in batches of 50, then deletes among the
    top 40 keys.  Each batch hangs below a longer chain of ΔNodes, so the
    paths to the top 50 keys run 40-70 ΔNodes deep, past the scan kernel's
    32-entry path stack, and the deletes leave tombstones there.  The tree
    of ``chip_smoke.py``'s ``deep_scan_check``."""
    from repro_torch.core import deltatree as DT

    cfg = DT.TreeConfig(height=3, max_dnodes=4096, buf_cap=8,
                        payload_bits=payload_bits, engine="lockstep")
    t = DT.bulk_build(cfg, np.arange(1, 5, dtype=np.int32),
                      np.arange(1, 5) if payload_bits else None, device="cpu")
    for s in range(0, n_keys, 50):
        keys = np.arange(10 + s, 60 + s, dtype=np.int32)
        t, _, _ = DT.update_batch(cfg, t, np.ones(50, np.int32), keys,
                                  keys % 97)
    dels = np.arange(n_keys - 30, n_keys + 10, 3, dtype=np.int32)
    t, _, _ = DT.update_batch(cfg, t, np.full(dels.size, 2, np.int32), dels)
    return cfg, t


def np_of(x) -> np.ndarray:
    """A JAX array or a torch tensor as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_cols_equal(a_cols, b_cols, names, where="") -> None:
    for name, a, b in zip(names, a_cols, b_cols):
        a, b = np_of(a), np_of(b)
        assert a.dtype == b.dtype, (where, name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}: {name}")


def assert_stats_equal(a, b, where=""):
    """Two stats tuples (JAX or port, nested ReadStats included) equal
    field for field: dtype, shape and values."""
    assert type(a).__name__ == type(b).__name__, where
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, (where, name)
        elif hasattr(x, "_fields"):
            assert_stats_equal(x, y, f"{where}.{name}")
        else:
            x, y = np_of(x), np_of(y)
            assert x.dtype == y.dtype and x.shape == y.shape, (where, name)
            np.testing.assert_array_equal(x, y, err_msg=f"{where}.{name}")


def stack_stats(items):
    """Stack port stats tuples of one class field by field along a new
    leading axis: the (S,) input of their ``reduce``."""
    import torch

    return type(items[0])(*(torch.stack(xs) for xs in zip(*items)))


def shared_npz(tmp_path_factory, name: str, make) -> dict:
    """``make(path)`` writes an ``.npz`` once per test run, shared by every
    pytest-xdist worker (the first worker to ask runs it under a file lock,
    the others wait and read); returns its arrays.  For the JAX side of a
    parity test that runs in a subprocess."""
    import fcntl
    import os

    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / f"{name}.npz"
    with open(root / f"{name}.lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if not path.exists():
                make(path)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def prefixed(arrays: dict, prefix: str) -> dict:
    """The entries of ``arrays`` under ``prefix/``, with it stripped."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in arrays.items() if k.startswith(prefix + "/")}


def jax_npz(tmp_path_factory, name: str, code: str, x64: bool = True) -> dict:
    """Run ``code`` (which fills a dict ``rec`` with numpy arrays) in a
    subprocess, once per test run for every xdist worker (`shared_npz`),
    and return ``rec``.  For JAX sides that need x64."""
    import os

    from _subproc import run_py

    def make(path):
        tmp = f"{path}.part.npz"
        run_py(f"{code}\nimport numpy as _np\n_np.savez({tmp!r}, **rec)\n",
               x64=x64, timeout=900)
        os.replace(tmp, path)

    return shared_npz(tmp_path_factory, name, make)


# pager stats in a fixed order (the JAX and the port pager count the same)
STAT_KEYS = ("searches", "inserts", "deletes", "hops", "flushes",
             "maint_rebuilds", "maint_expands", "maint_merges", "combined",
             "inline_maint")

# The start of every serving scenario's JAX side: the smoke model's params
# (recorded under ``param/`` in the port's state_dict names) and
# ``pager_state``, which records a pager's stats, free list and arena.
SERVE_PRELUDE = f"STAT_KEYS = {STAT_KEYS!r}\n" + r'''
import numpy as np, jax
from repro.configs import get_smoke_config
from repro.models.registry import api
from repro_torch.models.weights import jax_state_dict
rec = {}
def pager_state(prefix, pg):
    rec[f"{prefix}/stats"] = np.asarray([pg.stats[k] for k in STAT_KEYS])
    rec[f"{prefix}/free"] = np.asarray(pg.free_pages, np.int64)
    for k, v in pg.index.state._asdict().items():
        rec[f"{prefix}/tree/{k}"] = np.asarray(v)
cfg = get_smoke_config("granite_8b")
m = api(cfg)
params = m.init_params(jax.random.PRNGKey(0))
for k, v in jax_state_dict(cfg, jax.tree.map(np.asarray, params)).items():
    rec["param/" + k] = np.asarray(v)
'''


def serve_model(rec):
    """The port's smoke Granite with the weights a JAX side recorded under
    ``param/``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import Transformer
    from repro_torch.models.weights import load_state

    cfg = get_smoke_config("granite_8b")
    return load_state(Transformer(cfg, device="cpu", init=False),
                      prefixed(rec, "param"))


def check_pager(rec, prefix: str, pg) -> None:
    """A port pager's stats, free list and 16 arena arrays equal what
    ``pager_state(prefix, ...)`` recorded on the JAX side."""
    np.testing.assert_array_equal(rec[f"{prefix}/stats"],
                                  [pg.stats[k] for k in STAT_KEYS],
                                  err_msg=f"{prefix}: pager stats")
    np.testing.assert_array_equal(rec[f"{prefix}/free"], pg.free_pages,
                                  err_msg=f"{prefix}: free list")
    assert_trees_equal(prefixed(rec, f"{prefix}/tree"), pg.index.state,
                       prefix)


# ------------------------------------------------------------- invariants ---


def check_invariants(cfg, t, require_empty_buffers: bool = True) -> None:
    """Structural invariants I1-I5 of a port tree (the port's copy of
    ``tests/test_deltatree.py::check_invariants``).

    ``require_empty_buffers=False`` checks the variant of the non-eager
    policies (I5 relaxed to I5'): I1-I4 plus exact buffer bookkeeping.
    """
    from repro_torch.core import layout

    pos = np.asarray(layout.veb_pos_table(cfg.height))
    value, child, buf = np_of(t.value), np_of(t.child), np_of(t.buf)
    alive, nlive, mark = np_of(t.alive), np_of(t.nlive), np_of(t.mark)
    parent, pslot, bcount = np_of(t.parent), np_of(t.pslot), np_of(t.bcount)
    bottom0 = cfg.bottom0
    rl = int(cfg.route_left)
    empty = int(layout.EMPTY)

    if require_empty_buffers:
        assert int(bcount.sum()) == 0, "I5: buffers drained"
        assert (buf == empty).all(), "I5"
    else:
        assert (bcount == (buf != empty).sum(axis=1)).all(), "bcount"

    for dn in range(cfg.max_dnodes):
        if not alive[dn]:
            assert (value[dn] == empty).all()
            continue
        count_live = 0
        for b in range(1, 2**cfg.height):
            v = value[dn, pos[b]]
            if b % 2 == 1 and b > 1 and v != empty:
                assert value[dn, pos[b - 1]] != empty, ("I2", dn, b)
            if b >= bottom0 and child[dn, b - bottom0] >= 0:
                assert v != empty, ("I3", dn, b)
                cid = child[dn, b - bottom0]
                assert alive[cid] and parent[cid] == dn and \
                    pslot[cid] == b - bottom0, ("child link", dn, b)
            at_bottom = b >= bottom0
            left = empty if at_bottom else value[dn, pos[2 * b]]
            is_leaf = at_bottom or left == empty
            if is_leaf and v not in (empty, rl) and not mark[dn, pos[b]]:
                if not (at_bottom and child[dn, b - bottom0] >= 0):
                    count_live += 1
        assert count_live == nlive[dn], ("nlive", dn, count_live, nlive[dn])

    # walk-cap safety: the deepest alive ΔNode sits strictly under the
    # walk round cap, or a capped walk would stop short of its leaf
    max_depth = tree_depth(t)
    assert max_depth < cfg.walk_round_cap, \
        ("walk cap", max_depth, cfg.walk_round_cap)


def tree_depth(t) -> int:
    """ΔNodes on the longest root-to-ΔNode path of a port tree."""
    parent, alive = np_of(t.parent), np_of(t.alive)
    depth: dict[int, int] = {}

    def _depth(dn: int) -> int:
        if dn not in depth:
            p = int(parent[dn])
            depth[dn] = 1 if p < 0 else _depth(p) + 1
        return depth[dn]

    return max((_depth(dn) for dn in range(alive.size) if alive[dn]),
               default=0)


# ----------------------------------------------------------------- forest ---


def port_fcfg(jfcfg):
    """The port's ForestConfig with every field of the JAX one."""
    from repro_torch.distributed.forest import ForestConfig

    return ForestConfig(num_shards=jfcfg.num_shards,
                        tree=port_cfg(jfcfg.tree), key_min=jfcfg.key_min,
                        key_max=jfcfg.key_max, fused=jfcfg.fused)


def assert_forests_equal(jf, tf, where="") -> None:
    """Every shard's 16 arena arrays, the splits and the per-shard op
    counters equal.  ``jf`` is a JAX Forest or, as a subprocess passes it
    back, a dict of its stacked (S, ...) tree arrays plus ``splits`` /
    ``reads`` / ``updates``."""
    from repro_torch.distributed import forest as TF

    if isinstance(jf, dict):
        trees = {k[6:]: v for k, v in jf.items() if k.startswith("trees/")}
        rest = {k: jf[k] for k in ("splits", "reads", "updates")}
    else:
        trees = jax_arrays(jf.trees)
        rest = {k: np.asarray(getattr(jf, k))
                for k in ("splits", "reads", "updates")}
    s = tf.trees.value.shape[0]
    for i in range(s):
        assert_trees_equal({k: v[i] for k, v in trees.items()},
                           TF.shard_tree(tf, i), f"{where} shard {i}")
    for k, v in rest.items():
        np.testing.assert_array_equal(v, np_of(getattr(tf, k)),
                                      err_msg=f"{where}: {k}")


def forest_record(rec: dict, prefix: str, jf) -> None:
    """Record a JAX forest's stacked arrays under ``prefix/`` (the JAX
    side of a subprocess parity leg); `assert_forests_equal` reads them
    back with ``prefixed(rec, prefix)``."""
    for k, v in jf.trees._asdict().items():
        rec[f"{prefix}/trees/{k}"] = np.asarray(v)
    for k in ("splits", "reads", "updates"):
        rec[f"{prefix}/{k}"] = np.asarray(getattr(jf, k))


def forest_trace(seed: int, steps: int, key_hi: int, *, n_init: int = 200,
                 k_read: int = 61, k_scan: int = 13, k_upd: int = 32,
                 payload_bits: int = 0):
    """A forest parity trace drawn from ``seed`` with numpy, the same on
    both sides: initial keys (and payloads), then per step a read batch
    (``k_read`` keys, some above every key and below the domain), a scan
    batch (``k_scan`` bands, wide and narrow), and an update batch
    (``k_upd`` mixed inserts and deletes, with payloads; its first 16 rows
    insert four runs of 4 consecutive keys, which fill overflow buffers
    under deferred maintenance).  Read and scan batch sizes are odd on
    purpose: no multiple of 4 or 64."""
    rng = np.random.default_rng(seed)
    init = np.unique(rng.integers(1, key_hi, n_init)).astype(np.int32)
    pays = (rng.integers(0, 2**payload_bits - 1, init.size).astype(np.int32)
            if payload_bits else None)
    out = []
    for _ in range(steps):
        q = rng.integers(0, key_hi + 50, k_read).astype(np.int32)
        st = rng.integers(0, key_hi, k_scan).astype(np.int32)
        hi = (st + rng.choice([5, 60, key_hi], k_scan)).astype(np.int32)
        kinds = rng.choice([1, 2], k_upd).astype(np.int32)
        keys = rng.integers(1, key_hi, k_upd).astype(np.int32)
        runs = rng.integers(1, key_hi - 5, 4)
        keys[:16] = (runs[:, None] + np.arange(1, 5)).ravel()
        kinds[:16] = 1
        pp = (rng.integers(0, 2**payload_bits - 1, k_upd).astype(np.int32)
              if payload_bits else np.zeros(k_upd, np.int32))
        out.append(dict(q=q, st=st, hi=hi, kinds=kinds, keys=keys, pays=pp))
    return init, pays, out


SCAN_COLS = ("out", "n", "hops", "more")
FOREST_MAX_ITEMS, FOREST_SUCC_K = 7, 5


def forest_cfgs(num_shards: int, policy: str, payload_bits: int,
                key_hi: int, *, jax: bool):
    """(update config, fused lockstep read config) of one forest parity
    leg — the JAX package's (``jax=True``) or the port's.  The JAX side
    updates under the scalar engine, the port under the lockstep one: the
    arenas must come out the same."""
    if jax:
        from repro.core import TreeConfig
        from repro.distributed.forest import ForestConfig
    else:
        from repro_torch.core.deltatree import TreeConfig
        from repro_torch.distributed.forest import ForestConfig

    def mk(engine):
        return ForestConfig(
            num_shards=num_shards, key_max=key_hi,
            tree=TreeConfig(height=4, max_dnodes=256, buf_cap=8,
                            payload_bits=payload_bits, engine=engine,
                            maintenance=policy))

    return mk("scalar" if jax else "lockstep"), mk("lockstep")


def jax_forest_leg(num_shards: int, policy: str, payload_bits: int, *,
                   seed: int, steps: int, key_hi: int) -> dict:
    """Drive the JAX forest through `forest_trace`: per step the fused
    lockstep reads (lookup, successor, scan, successor_k), then the
    update batch; record every column, the results, the stats and the
    forest (`forest_record`) under ``"{step}/..."``."""
    import jax.numpy as jnp
    from repro.distributed import forest as F

    fc_u, fc_r = forest_cfgs(num_shards, policy, payload_bits, key_hi,
                             jax=True)
    init, pays, trace = forest_trace(seed, steps, key_hi,
                                     payload_bits=payload_bits)
    f = F.bulk_build(fc_u, init, pays)
    rec = {}
    for i, st in enumerate(trace):
        q = jnp.asarray(st["q"])
        cols = {
            "lookup": (("found", "payload", "hops"),
                       F.lookup_batch(fc_r, f, q)),
            "succ": (("found", "succ"), F.successor_jit(fc_r, f, q)),
            "scan": (SCAN_COLS, F.scan_batch(
                fc_r, f, jnp.asarray(st["st"]), jnp.asarray(st["hi"]),
                max_items=FOREST_MAX_ITEMS)),
            "succk": (SCAN_COLS, F.successor_k(fc_r, f, q, FOREST_SUCC_K)),
        }
        for read, (names, out) in cols.items():
            for name, col in zip(names, out):
                rec[f"{i}/{read}/{name}"] = np.asarray(col)
        f, res, stats = F.update_batch(
            fc_u, f, jnp.asarray(st["kinds"]), jnp.asarray(st["keys"]),
            jnp.asarray(st["pays"]))
        rec[f"{i}/res"] = np.asarray(res)
        rec[f"{i}/stats"] = np.asarray(list(stats.asdict().values()))
        forest_record(rec, f"{i}/forest", f)
    return rec


# ----------------------------------------------------------- sharded pager ---

# the sharded pager script of tests/test_forest.py::
# test_sharded_pager_x64_8_devices: (op, seq, n) — allocate n blocks, free a
# sequence, or read the block tables of the sequences listed (n blocks)
SHARDED_PAGER = dict(num_pages=128, page_size=4, max_seqs=32, max_blocks=64,
                     tree_height=4, num_shards=4)
SHARDED_SCRIPT = (("alloc", 0, 3), ("alloc", 9, 2), ("tables", (0, 9), 4),
                  ("alloc", 0, 2), ("tables", (0,), 5), ("free", 0, 0),
                  ("tables", (0, 9), 4), ("free", 9, 0))
# the scheduler leg: the churn trace of tests/test_torch_serve_sched.py
# over a forest-backed pager
SHARDED_CHURN = dict(num_pages=128, page_size=4, max_blocks=32, max_seqs=32,
                     tree_height=4, num_shards=4, maintenance="deferred",
                     maint_high_water=6, engine="lockstep")
SHARDED_TRACE = dict(arrive_p=0.6, prompt_lens=(3, 9), max_new=(3, 7),
                     cancel_p=0.25, probes_per_step=12)


def run_sharded_script(pg, after=None):
    """Run `SHARDED_SCRIPT` on a sharded pager; returns the block tables
    each "tables" op read, as numpy.  ``after(i, pg)`` runs after op i."""
    tables = []
    for i, (op, seq, n) in enumerate(SHARDED_SCRIPT):
        if op == "alloc":
            pg.allocate(seq, n)
        elif op == "free":
            pg.free_seq(seq)
        else:
            tables.append(np_of(pg.block_tables(list(seq), n)))
        if after is not None:
            after(i, pg)
    return tables


def sharded_pager_state(rec: dict, prefix: str, pg) -> None:
    """Record a sharded pager's stats, free list and forest."""
    rec[f"{prefix}/stats"] = np.asarray([pg.stats[k] for k in STAT_KEYS])
    rec[f"{prefix}/free"] = np.asarray(pg.free_pages, np.int64)
    forest_record(rec, f"{prefix}/forest", pg.index.state)


def check_sharded_pager(rec, prefix: str, pg) -> None:
    np.testing.assert_array_equal(rec[f"{prefix}/stats"],
                                  [pg.stats[k] for k in STAT_KEYS],
                                  err_msg=f"{prefix}: pager stats")
    np.testing.assert_array_equal(rec[f"{prefix}/free"], pg.free_pages,
                                  err_msg=f"{prefix}: free list")
    assert_forests_equal(prefixed(rec, f"{prefix}/forest"), pg.index.state,
                         prefix)


def record_step_views(sch) -> list:
    """Wrap ``sch.step`` so each step's fused-view (hits, builds) lands in
    the returned list."""
    seen = []
    step = sch.step

    def counted():
        out = step()
        info = sch.last_step_info
        seen.append((info["view_hits"], info["view_builds"]))
        return out

    sch.step = counted
    return seen


# The JAX side of the sharded legs of test_torch_serving.py and
# test_torch_serve_sched.py (one subprocess for both, run with
# SERVE_PRELUDE in front).
SHARDED_JAX = f"""
SHARDED_PAGER = {SHARDED_PAGER!r}
SHARDED_CHURN = {SHARDED_CHURN!r}
SHARDED_TRACE = {SHARDED_TRACE!r}
""" + r'''
import sys
sys.path.insert(0, TESTS)
from _torch_parity import (
    forest_record, record_step_views, run_sharded_script,
    sharded_pager_state,
)
from repro.distributed import forest as DF
from repro.serve import SchedulerConfig, ServeScheduler, synth_trace
from repro.serving import ShardedDeltaPager, ShardedPagerConfig

pg = ShardedDeltaPager(ShardedPagerConfig(**SHARDED_PAGER))
tables = run_sharded_script(
    pg, lambda i, p: sharded_pager_state(rec, f"script/{i}", p))
for i, t in enumerate(tables):
    rec[f"script/tables/{i}"] = np.asarray(t)

DF.reset_fused_view_cache()
sch = ServeScheduler(cfg, params, ShardedPagerConfig(**SHARDED_CHURN),
                     SchedulerConfig(max_live=3))
views = record_step_views(sch)
plans = synth_trace(14, seed=11, vocab=cfg.vocab_size, **SHARDED_TRACE)
summary = sch.run_trace(plans)
for sid, req in sch.active.items():
    rec[f"sched/tokens/{sid}"] = np.asarray(req.out, np.int64)
rec["sched/views"] = np.asarray(views, np.int64)
obs = sch.obs.asdict()
rec["sched/obs"] = np.asarray([obs["view_hits"], obs["view_builds"]])
rec["sched/cache"] = np.asarray([DF.fused_view_cache_stats()[k]
                                 for k in ("builds", "hits")])
sharded_pager_state(rec, "sched", sch.pager)
'''


def jax_sharded(tmp_path_factory) -> dict:
    """The JAX side of the sharded-pager legs (x64, one subprocess a run)."""
    from pathlib import Path

    tests = str(Path(__file__).resolve().parent)
    return jax_npz(tmp_path_factory, "torch_sharded",
                   f"TESTS = {tests!r}\n" + SERVE_PRELUDE + SHARDED_JAX)
