"""PyTorch port: the dry-run (``repro_torch.launch.dryrun``), its counts
(``analysis.count``), roofline (``analysis.roofline``), tables
(``analysis.report``) and ``models.registry.input_specs``, held against the
JAX package's on the CPU.

``repro.launch.dryrun`` is never imported here: its first statement sets
``XLA_FLAGS`` to 512 host devices, which would change every later JAX test
in the process.  Its pieces that do not set it (``repro.models.registry``,
``repro.analysis``) are the reference.

Caches are compared layer by layer: the port's are a list of per-layer
dicts, JAX's ``{"prologue", "slots"}`` with each slot stacked over the
pattern's repetitions, so JAX's are unstacked into the port's layer order
(prologue layers, then repetition r's slot j as layer ``n_pro + r * period
+ j``); an encoder-decoder's L-stacked dict is the same on both sides.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import pytest
import torch

from repro.analysis import report as JR
from repro.analysis import roofline as JRF
from repro.configs import get_config as j_get
from repro.launch import mesh as JM
from repro.models import registry as JREG
from repro_torch.analysis import report as TRP
from repro_torch.analysis import roofline as TRF
from repro_torch.analysis.count import count
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as TM
from repro_torch.models import registry as TREG
from repro_torch.models.transformer import _layout

H100 = "NVIDIA H100 80GB HBM3"
B, S, MAX_LEN = 2, 24, 32      # the smoke steps: rows, tokens, cache


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _jax_layers(cfg, caches) -> list | dict:
    """JAX's cache stand-ins in the port's layer order (see the module
    docstring)."""
    if cfg.family == "audio":
        return caches
    n_pro, period, reps = _layout(cfg)
    out = list(caches["prologue"])
    for r in range(reps):
        for j in range(period):
            out.append({k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
                        for k, v in caches["slots"][j].items()})
    return out


def _same_leaves(port, ref, where: str) -> None:
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref), where
        for k in ref:
            _same_leaves(port[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), where
        for i, (p, r) in enumerate(zip(port, ref)):
            _same_leaves(p, r, f"{where}[{i}]")
    else:
        assert port.device.type == "meta", where
        assert tuple(port.shape) == tuple(ref.shape), where
        assert _dtype(port) == _dtype(ref), where


@pytest.mark.parametrize("shape", list(TREG.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_jax(arch, shape):
    """The same step kind, keys, leaf shapes and dtypes as JAX's
    ``input_specs``, every leaf a meta tensor; the same skip."""
    cfg, jcfg = get_config(arch), j_get(arch)
    assert TREG.shape_applicable(cfg, shape) == JREG.shape_applicable(
        jcfg, shape)
    kind, specs = TREG.input_specs(cfg, shape)
    jkind, jspecs = JREG.input_specs(jcfg, shape)
    assert kind == jkind
    assert set(specs) == set(jspecs)
    for k, ref in jspecs.items():
        if k == "caches":
            ref = _jax_layers(jcfg, ref)
        _same_leaves(specs[k], ref, f"{arch}/{shape}/{k}")


def test_input_specs_batch_override():
    kind, specs = TREG.input_specs(get_config("granite_8b"), "decode_32k",
                                   batch_override=8)
    _, jspecs = JREG.input_specs(j_get("granite_8b"), "decode_32k",
                                 batch_override=8)
    assert kind == "decode"
    _same_leaves(specs["caches"], _jax_layers(j_get("granite_8b"),
                                              jspecs["caches"]), "caches")
    assert tuple(specs["token"].shape) == (8, 1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_active_params_equal_jax(arch):
    cfg, jcfg = get_config(arch), j_get(arch)
    n = TREG.model_class(cfg)(cfg, device="meta", init=False).param_count()
    n_active = TRF.active_params(cfg, n)
    assert n_active == JRF.active_params(jcfg, n)
    for kind in ("train", "prefill", "decode"):
        assert TRF.model_flops(cfg, kind, 4096, n, n_active) == \
            JRF.model_flops(jcfg, kind, 4096, n, n_active)


@pytest.mark.parametrize("flops,nbytes,wire,chips", [
    (6.9e16, 7.8e14, 0.0, 1), (4.5e12, 7.0e12, 3.2e9, 4), (0.0, 1e6, 0.0, 1)])
def test_roofline_terms_times_constants_equal_jax(flops, nbytes, wire, chips):
    """Each term times its constant gives back the same count on both
    sides; what does not depend on a constant is equal."""
    cost = {"flops": flops, "bytes accessed": nbytes}
    coll = {"total_wire_bytes": wire}
    mf = 3.1e15
    card = TM.card(H100)
    t = TRF.roofline_terms(cost, coll, mf, chips, card)
    j = JRF.roofline_terms(cost, coll, mf, chips)
    assert t.compute_s * card.PEAK_FLOPS_BF16 == pytest.approx(
        j.compute_s * JM.PEAK_FLOPS_BF16, rel=1e-12)
    assert t.memory_s * card.HBM_BW == pytest.approx(j.memory_s * JM.HBM_BW,
                                                     rel=1e-12)
    assert t.collective_s * card.ICI_BW == pytest.approx(
        j.collective_s * JM.ICI_BW, rel=1e-12)
    for k in ("flops", "hbm_bytes", "wire_bytes", "model_flops_per_device",
              "useful_flops_ratio"):
        assert getattr(t, k) == getattr(j, k), k
    assert set(t.as_dict()) == set(j.as_dict())


def test_card_rows():
    """The H100 row under JAX's names; an unknown card raises."""
    c = TM.card(H100)
    assert (c.PEAK_FLOPS_BF16, c.HBM_BW, c.HBM_PER_CHIP, c.ICI_BW) == (
        989e12, 3.35e12, 80e9, 450e9)
    with pytest.raises(KeyError, match="no constants"):
        TM.card("NVIDIA A100-SXM4-80GB")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.card()


def _records() -> list:
    """Records of every status, with one of JAX's schema per kind."""
    coll = TRF.no_collectives()
    coll["counts"]["all-reduce"] = 3
    ok = {"arch": "granite_8b", "shape": "train_4k", "mesh": "card1",
          "status": "ok", "compile_s": 12.5,
          "memory": {"argument_size_bytes": 48328565248,
                     "temp_size_bytes": 214426667008},
          "collectives": coll,
          "roofline": {"compute_s": 0.2, "memory_s": 1.3e-4,
                       "collective_s": 0.0, "bottleneck": "compute",
                       "useful_flops_ratio": 0.73},
          "roofline_extrapolated": {"compute_s": 69.8, "memory_s": 232.9,
                                    "collective_s": 0.0,
                                    "bottleneck": "memory",
                                    "useful_flops_ratio": 0.731}}
    return [ok,
            dict(ok, mesh="pod1"),
            dict(ok, shape="decode_32k", roofline_extrapolated=None),
            {"arch": "qwen1_5_110b", "shape": "long_500k", "mesh": "card1",
             "status": "skipped", "reason": "long_500k skipped: pure "
             "full-attention arch (per assignment)"},
            {"arch": "jamba_1_5_large_398b", "shape": "prefill_32k",
             "mesh": "card1", "status": "error",
             "error": "RuntimeError: " + "x" * 80}]


def test_report_renders_like_jax():
    recs = _records()
    for mesh in ("card1", "pod1"):
        assert TRP.dryrun_table(recs, mesh) == JR.dryrun_table(recs, mesh)
        assert TRP.roofline_table(recs, mesh) == JR.roofline_table(recs, mesh)
    assert TRP.fmt_bytes(3.5e9) == JR.fmt_bytes(3.5e9)
    assert TRP.fmt_s(2.5e-4) == JR.fmt_s(2.5e-4)


@pytest.fixture(scope="module")
def decode_records(tmp_path_factory):
    """The CLI's records of two whole decode cells at one row a batch (a
    dense 36-layer and an SSM's long context), written and loaded back."""
    out = tmp_path_factory.mktemp("dryrun")
    for arch, shape in (("granite_8b", "decode_32k"),
                        ("mamba2_370m", "long_500k"),
                        ("qwen1_5_110b", "long_500k")):
        assert D.main(["--arch", arch, "--shape", shape, "--batch", "1",
                       "--card", H100, "--out", str(out)]) == 0
    return TRP.load(out)


def test_cli_records_keep_jax_schema(decode_records):
    """Every key JAX's record has; full-depth roofline, no probes; no
    collectives on one card; the report renders them as JAX's would."""
    ok = [r for r in decode_records if r["status"] == "ok"]
    assert len(ok) == 2 and len(decode_records) == 3
    for r in ok:
        for k in ("arch", "shape", "mesh", "status", "step_kind", "n_chips",
                  "n_params", "n_active_params", "n_tokens_global",
                  "memory", "cost_analysis", "collectives", "roofline",
                  "accum_steps", "roofline_extrapolated"):
            assert k in r, k
        assert set(r["memory"]) == {"argument_size_bytes",
                                    "output_size_bytes", "temp_size_bytes",
                                    "peak_bytes"}
        assert r["memory"]["peak_bytes"] == (
            r["memory"]["argument_size_bytes"]
            + r["memory"]["temp_size_bytes"])
        assert set(r["cost_analysis"]) == {"flops", "bytes accessed"}
        assert r["collectives"]["total_wire_bytes"] == 0.0
        assert set(r["collectives"]["counts"]) == set(
            JRF.collective_stats("")["counts"])
        rx = r["roofline_extrapolated"]
        assert rx["probe_reps"] == [] and rx["flops"] == r["roofline"]["flops"]
        assert (r["mesh"], r["n_chips"], r["step_kind"]) == ("card1", 1,
                                                             "decode")
        json.dumps(r)
    assert TRP.dryrun_table(decode_records) == JR.dryrun_table(
        decode_records, "card1")
    assert TRP.roofline_table(decode_records) == JR.roofline_table(
        decode_records, "card1")


def test_dense_decode_count_by_hand(decode_records):
    """Granite-8B's decode of one row against a 32 k cache: the products
    are every weight matrix once (2 FLOPs a weight; the tied embedding
    once, as the logits' product; the norms' vectors none) plus the
    attention's two products over the whole cache; the arguments are the
    weights and the bf16 cache."""
    r = next(r for r in decode_records if r["arch"] == "granite_8b")
    cfg = get_config("granite_8b")
    n, s = r["n_params"], 32768
    norms = (2 * cfg.num_layers + 1) * cfg.d_model
    attn = 2 * 2 * cfg.num_layers * cfg.num_heads * cfg.head_dim * s
    assert r["cost_analysis"]["flops"] == 2 * (n - norms) + attn
    cache = 2 * cfg.num_layers * s * cfg.num_kv_heads * cfg.head_dim * 2
    assert r["memory"]["argument_size_bytes"] >= 2 * n + cache
    assert r["memory"]["argument_size_bytes"] < 2 * n + cache + 1e6


def test_mesh_and_card_flags_raise(tmp_path):
    """A mesh the dry-run does not know raises (pod1 / pod2 run: the
    pod cells are in tests/test_torch_parallel.py); so does a run with
    no card and no card's row named, on any mesh."""
    with pytest.raises(ValueError, match="unknown mesh"):
        D.lower_cell("granite_8b", "decode_32k", "pod3", card=H100)
    with pytest.raises(SystemExit):
        D.main(["--mesh", "pod3", "--arch", "granite_8b", "--card", H100,
                "--out", str(tmp_path)])
    if not torch.cuda.is_available():
        for mesh in ("card1", "pod1"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                D.main(["--arch", "granite_8b", "--mesh", mesh, "--out",
                        str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_count_by_hand():
    """A product and an add: FLOPs 2 m n k, the bytes of each op's
    tensors (the transpose, a view, moves none), the peak the arguments
    plus both results, each rounded to 512 bytes."""
    a = torch.ones(64, 64)
    b = torch.ones(64, 64)

    def fn():
        c = a @ b.t()
        return c + 1

    out, c = count(fn, (a, b))
    assert c.flops == 2 * 64 ** 3
    assert c.bytes == 3 * 16384 + 2 * 16384
    assert (c.argument_bytes, c.output_bytes) == (32768, 16384)
    assert c.peak_bytes == 65536 and c.temp_bytes == 32768
    assert float(out[0, 0]) == 65.0
    _, c = count(lambda: torch.zeros(3), ())
    assert (c.bytes, c.peak_bytes) == (12, 512)


def _bytes_of(fn) -> tuple[int, dict]:
    _, c = count(fn, live=False)
    return c.bytes, c.by_op


def test_count_partial_reads_and_writes_by_hand():
    """An op that touches part of a tensor moves only that part: a decode's
    cache write (``index_put_``: the indices, the values read, the row
    written) into a 32 k-token cache, a slice's ``copy_`` (the source
    read, the slice written), an embedding's gather (the indices, the rows
    read and written), an ``index_add_`` (the rows read and written), a
    broadcast operand (its distinct elements once)."""
    cache = torch.zeros(4, 32768, 8)
    rows = torch.arange(4)
    length = torch.full((4,), 7, dtype=torch.int32)
    vals = torch.ones(4, 8)

    def write():
        cache[rows, length] = vals

    assert _bytes_of(write) == (4 * 8 + 4 * 4 + 2 * 4 * 8 * 4,
                                {"aten.index_put_.default": 1})
    assert float(cache[2, 7, 3]) == 1.0 and float(cache.sum()) == 32.0
    dst, src = torch.zeros(4, 16, 8), torch.ones(4, 2, 8)
    assert _bytes_of(lambda: dst[:, :2].copy_(src))[0] == 2 * 4 * 2 * 8 * 4
    assert _bytes_of(lambda: dst.copy_(dst + 1))[0] == 4 * (2 + 2) * 512
    table, tokens = torch.ones(1000, 16), torch.tensor([3, 1, 4, 1, 5])
    assert _bytes_of(lambda: table[tokens]) == (
        5 * 8 + 2 * 5 * 16 * 4, {"aten.index.Tensor": 1})
    assert _bytes_of(lambda: torch.embedding(table, tokens))[0] == (
        5 * 8 + 2 * 5 * 16 * 4)
    acc, idx, src = torch.zeros(10, 8), torch.tensor([0, 9, 2]), torch.ones(
        3, 8)
    assert _bytes_of(lambda: acc.index_add_(0, idx, src))[0] == (
        3 * 8 + 3 * 8 * 4 + 2 * 3 * 8 * 4)
    x, y = torch.ones(4, 8), torch.ones(1, 8)
    assert _bytes_of(lambda: x * y.expand(4, 8))[0] == (128 + 32 + 128)


def test_flops_equal_flop_counter_mode():
    """The count's products are FlopCounterMode's total over the same
    train step (the smoke Granite, remat on)."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = dataclasses.replace(get_smoke_config("granite_8b"), remat=True)
    got = []
    for use_mode in (False, True):
        model, inputs, opt = D.smoke_inputs(cfg, "train", "meta", B, S,
                                            MAX_LEN)
        fn, held = D.step_call(cfg, "train", model, inputs, opt)
        if use_mode:
            with FlopCounterMode(display=False) as fc:
                fn()
            got.append(fc.get_total_flops())
        else:
            got.append(count(fn, held, device="meta")[1].flops)
    assert got[0] == got[1] > 0


# ---------------------------- the count on meta = the count of a CPU run ---

@pytest.fixture
def one_thread():
    """One intra-op thread for the test (a CPU run's reductions in one
    order), the process's count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_count_equals_cpu_run(arch, kind, one_thread):
    """At each smoke config (remat on, as the full configs have it; a
    train step at accum_steps 2) the meta count of the port's step equals
    the count of the same step run on the CPU: the same FLOPs, bytes,
    ops and arguments exactly, the peak within 5 %."""
    cfg = dataclasses.replace(get_smoke_config(arch), remat=True)
    counts = []
    for device in ("meta", "cpu"):
        model, inputs, opt = D.smoke_inputs(cfg, kind, device, B, S,
                                            MAX_LEN)
        fn, held = D.step_call(cfg, kind, model, inputs, opt, accum_steps=2)
        counts.append(count(fn, held, device=device)[1])
    meta, cpu = counts
    assert meta.flops > 0 and meta.bytes > 0
    assert (meta.flops, meta.bytes, meta.ops, meta.argument_bytes) == (
        cpu.flops, cpu.bytes, cpu.ops, cpu.argument_bytes)
    assert abs(meta.peak_bytes - cpu.peak_bytes) <= 0.05 * cpu.peak_bytes
