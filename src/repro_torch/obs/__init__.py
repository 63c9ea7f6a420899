"""repro_torch.obs — observability (port of ``repro.obs``; DESIGN.md §9).

- **Counter tuples** (`obs.stats`): ``SearchStats`` for the read path,
  ``RouterStats`` for the forest router, ``TransferStats`` for measured
  memory transfers (carried together by ``ReadStats``, the trailing
  element of a read under ``TreeConfig.collect_stats``), ``ServeStats`` /
  ``ScanStats`` for the serve loop, and ``MaintenanceStats``.
- **Trace spans** (`obs.trace`): ``torch.profiler`` ranges around engine
  dispatch, router dispatch and the serve loop, gated by ``REPRO_TRACE``;
  ``capture`` / ``trace_run`` write a ``torch.profiler`` Chrome trace,
  ``write_chrome_trace`` the recorded span timeline.
- **Measured transfers** (`obs.transfers`): a replay of the descent on the
  arena's device giving ``TransferStats``, equal on a quiescent tree to
  `core.baselines.count_block_transfers` exactly.
- **Metrics export** (`obs.export`): stats → one named snapshot →
  Prometheus text / JSON (``ServeScheduler.metrics()`` produces it live).
- **Benchmark reports** (`obs.report`): the stdlib-only CLI that renders
  and diffs ``BENCH_*.json`` files::

      python -m repro_torch.obs.report BENCH_NEW.json --diff BENCH_OLD.json
      python -m repro_torch.obs.report BENCH_*.json --history
"""

from repro_torch.obs import export, report, stats, trace, transfers
from repro_torch.obs.stats import (
    MaintenanceStats,
    ReadStats,
    RouterStats,
    ScanStats,
    SearchStats,
    ServeStats,
    TransferStats,
)

__all__ = [
    "MaintenanceStats",
    "ReadStats",
    "RouterStats",
    "ScanStats",
    "SearchStats",
    "ServeStats",
    "TransferStats",
    "export",
    "report",
    "stats",
    "trace",
    "transfers",
]
