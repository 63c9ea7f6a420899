"""maint.seq_ops_per_kop: update ops the scheduler applied one by one (the
counter ``maint.seq_ops``, REPRO_TRACE; an op retried in a later round
counts again) per 1,000 update ops of the traced window.  The counters
are reset where the window starts and hold the whole window here.  None
where the program has no ``maint.batch`` span."""

from portbench.bench.stats import window


def read(run, name):
    from repro_torch.obs import trace

    c = trace.counters()
    ops = window(run, "n_writes").sum()
    if "maint.batch" not in c or not ops:
        return None
    return c.get("maint.seq_ops", 0) / ops * 1e3
