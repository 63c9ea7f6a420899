"""Cells cut to a size a CPU test can hold: the same files, with their
sizes overridden.  Beside the benchmark's cells, the mixes kept for later
cells (PERF.md, Open questions) run as cells of a test's own list."""

from __future__ import annotations

from portbench.bench import cells

CONFIG = {
    "fig12-set": {"data": {"draws": 20000, "key_max": 50000},
                  "arena": {"total_ops": 3000}},
    "ycsb-index-4m": {"data": {"recordcount": 20000},
                      "arena": {"total_ops": 40000}},
}
TRAFFIC = {
    "mixed-0": {"batch": 2048, "pool_steps": 4, "keep_reads": 4},
    "ycsb-c": {"batch": 2048, "pool_steps": 4, "keep_reads": 4},
    "ycsb-e": {"batch": 512, "pool_steps": 4, "keep_reads": 4,
               "max_steps": 2048},
    "mixed-10": {"batch": 256, "max_steps": 256},
}
LATER = ("fig12-set.mixed-0", "ycsb-index-4m.ycsb-c")


def bench() -> dict:
    """``BENCHMARK.json`` with the later cells added."""
    b = cells.load_bench()
    for name in LATER:
        cfg, mix = name.split(".")
        b["workloads"].append({"name": name, "config": cfg, "traffic": mix,
                               "chips": 1})
    return b


CELLS = tuple(w["name"] for w in cells.load_bench()["workloads"]) + LATER


def run(cell: str, seed: int = 20240611, seconds: float = 0.6,
        trace: bool = False, **kw) -> dict:
    from portbench.bench import runner

    cfg, mix = cell.split(".")
    return runner.run_cell(
        cell, seed, seconds, trace, device="cpu", bench=bench(),
        config_over=CONFIG[cfg], traffic_over=TRAFFIC[mix],
        log=lambda *a: None, **kw)
