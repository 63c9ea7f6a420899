"""read_p95_ms: the 95th percentile, over every read op of the window, of
the time from its step's start until its answer is on the host (CUDA
events on the stream: the device's clock)."""

from portbench.bench.stats import weighted_quantile, window


def read(run, name):
    return weighted_quantile(window(run, "read_ms"), window(run, "n_reads"),
                             0.95)
