"""The harness end to end on the CPU, at sizes a test can hold: every
cell's run is correct and prints the contract's keys; the control and
planted faults in the timed path come out not correct; a cell that
exists only as new files runs; nothing JAX is loaded."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

import small
from portbench.bench import cells, runner, system

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "checks"}


@pytest.mark.parametrize("cell", small.CELLS)
def test_cell_correct_with_the_contracts_keys(cell):
    out = small.run(cell)
    assert out["correct"], out["checks"]
    assert set(out) == RESULT_KEYS
    assert list(out)[-1] == "checks"
    bench = small.bench()
    want = {m["name"] for m in cells.metrics_for(bench, cell, False)}
    assert set(out["metrics"]) == want
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}


@pytest.mark.parametrize("cell", ["fig12-set.mixed-10",
                                  "ycsb-index-4m.ycsb-e"])
def test_traced_run_keys(cell):
    out = small.run(cell, trace=True, seconds=0.8)
    assert out["correct"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    bench = cells.load_bench()
    names = {m["name"] for m in cells.metrics_for(bench, cell, True)}
    # the CPU has no device trace: what reads one says nothing
    assert set(out["metrics"]) <= names
    assert set(out["metrics"]) & names


def _control(ds):
    # a small table's keys lie farther apart than float32's step (the
    # full YCSB table's do not): at this size bfloat16 is the nearest
    # float that merges keys, in both configurations
    return system.ReferenceSystem(ds, "cpu", torch.bfloat16)


@pytest.mark.parametrize("cell", small.CELLS)
def test_lower_precision_control_is_not_correct(cell):
    out = small.run(cell, replace=_control)
    assert not out["correct"]
    assert max(c["value"] for c in out["checks"].values()) > 0


class Fault:
    """The index with its timed path broken underneath."""

    def __init__(self, ix, kind):
        self.ix, self.kind = ix, kind

    def __getattr__(self, name):
        return getattr(self.ix, name)

    def _reads(self, out):
        out = [o.clone() for o in out]
        if self.kind == "half":          # the batch's second half left out
            for o in out[:-1]:
                o[o.shape[0] // 2:] = 0
        if self.kind == "alter":         # one answer altered where made
            out[0][0] = ~out[0][0] if out[0].dtype == torch.bool \
                else out[0][0] + 1
        return out

    def search(self, q):
        return tuple(self._reads(self.ix.search(q)))

    def lookup(self, q):
        return tuple(self._reads(self.ix.lookup(q)))

    def successor_k(self, q, k):
        return tuple(self._reads(self.ix.successor_k(q, k)))

    def update(self, batch):
        if self.kind == "stale":         # the step returns its state unchanged
            res = torch.zeros(batch.keys.shape[0], dtype=torch.bool)
            return self, res | (batch.kinds != 0), None
        ix, res, stats = self.ix.update(batch)
        self.ix = ix
        return self, res, stats


FAULTS = [(c, f) for c in small.CELLS for f in ("half", "alter")] + [
    ("fig12-set.mixed-10", "stale"), ("ycsb-index-4m.ycsb-e", "stale")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_timed_path_is_not_correct(cell, fault):
    out = small.run(cell, wrap=lambda ix, ds: Fault(ix, fault))
    assert not out["correct"], (cell, fault, out["checks"])


def test_a_cell_added_as_files_only(tmp_path):
    """A new configuration, mix and metric: new files and entries only."""
    pb = tmp_path / "portbench"
    for d in ("configs", "traffic", "metrics"):
        (pb / d).mkdir(parents=True)
    cfg = json.loads((cells.ROOT / "portbench/configs/fig12-set.json")
                     .read_text())
    cfg.update(data={"kind": "uniform_draws", "draws": 3000,
                     "key_max": 9000}, arena={"rule": "backend_kwargs",
                                              "total_ops": 500})
    (pb / "configs/tiny-set.json").write_text(json.dumps(cfg))
    (pb / "traffic/tiny-lookups.json").write_text(json.dumps(
        {"batch": 300, "reads": {"op": "search", "share": 1.0,
                                 "keys": {"dist": "uniform"}},
         "updates": None, "pool_steps": 2, "keep_reads": 3}))
    (pb / "metrics/steps_run.py").write_text(textwrap.dedent('''
        def read(run, name):
            return run.end - run.first
    '''))
    bench = {"configs": [{"name": "tiny-set", "file":
                          "portbench/configs/tiny-set.json"}],
             "workloads": [{"name": "tiny-set.tiny-lookups",
                            "config": "tiny-set", "traffic": "tiny-lookups",
                            "chips": 1}],
             "end_to_end": [{"name": "steps_run", "unit": "steps"}],
             "per_layer": []}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = runner.run_cell("tiny-set.tiny-lookups", 5, 0.3, False,
                          device="cpu", root=tmp_path, log=lambda *a: None)
    assert out["correct"]
    assert out["metrics"]["steps_run"]["value"] > 0


def _python(code: str, cwd) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_jax_loaded_and_the_reference_stands_alone():
    code = textwrap.dedent(f'''
        import sys
        sys.path[:0] = [{str(cells.ROOT)!r}, {str(cells.ROOT / "src")!r},
                        {str(cells.ROOT / "portbench/tests")!r}]
        import small
        from portbench.bench import runner
        for cell in small.CELLS:
            assert small.run(cell, seconds=0.3)["correct"]
        tops = {{m.split(".")[0] for m in sys.modules}}
        assert not tops & {{"jax", "jaxlib", "flax", "repro"}}, tops
        assert "repro_torch" in tops
        print("ok", runner.forbidden_modules())
    ''')
    p = _python(code, cells.ROOT)
    assert p.returncode == 0 and "ok []" in p.stdout, p.stderr[-3000:]
    ref = _python(textwrap.dedent(f'''
        import sys
        sys.path[:0] = [{str(cells.ROOT)!r}]
        import portbench.reference.sorted_index
        tops = {{m.split(".")[0] for m in sys.modules}}
        assert not tops & {{"jax", "repro", "repro_torch"}}, tops
        print("ok")
    '''), cells.ROOT)
    assert ref.returncode == 0 and "ok" in ref.stdout, ref.stderr[-3000:]


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert runner.forbidden_modules() == ["jaxlib"]


def test_without_a_card_no_result(tmp_path):
    """No CUDA card (this machine), and a directory that holds only
    ``BENCHMARK.json`` and ``portbench/``: exit code not 0, no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (cells.ROOT, tmp_path):
        p = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "fig12-set.mixed-10", "--seed", "3000000000", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300)
        assert p.returncode != 0 and not p.stdout.strip(), p


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", small.CELLS)
def test_cell_on_the_card(cell):
    from portbench.bench import runner as R

    cfg, mix = cell.split(".")
    out = R.run_cell(cell, 77, 0.5, True, device="cuda",
                     bench=small.bench(), config_over=small.CONFIG[cfg],
                     traffic_over=small.TRAFFIC[mix], log=lambda *a: None)
    assert out["correct"] and out["device"]["busy_s"] > 0
