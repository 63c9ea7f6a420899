"""host.read_p95_ms: read_p95_ms over the traced run's steps before its
profiled stretch (spans on): the read tail where the host sets the pace."""

from portbench.bench.stats import weighted_quantile, window


def read(run, name):
    return weighted_quantile(window(run, "read_ms", True),
                             window(run, "n_reads", True), 0.95)
