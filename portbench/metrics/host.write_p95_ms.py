"""host.write_p95_ms: the 95th percentile, over every update op of the
traced run's steps before its profiled stretch, of the time from its
step's start until its update result is on the host."""

from portbench.bench.stats import weighted_quantile, window


def read(run, name):
    return weighted_quantile(window(run, "write_ms", True),
                             window(run, "n_writes", True), 0.95)
