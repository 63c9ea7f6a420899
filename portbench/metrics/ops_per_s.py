"""ops_per_s: every operation the window completed (a read, a scan, an
insert or a delete counts one), over the window's host-clock seconds."""

from portbench.bench.stats import window


def read(run, name):
    ops = window(run, "n_reads").sum() + window(run, "n_writes").sum()
    return ops / run.window_s
