"""engine.launches_per_read: kernel launches the read engine's dispatch
issues a read call: the CUDA runtime calls that launch a kernel inside an
``engine.*`` range that lies in a ``client.read`` range of the profiled
stretch, per such read range.  The calls are named ``cudaLaunchKernel*``
or ``cuLaunchKernel*``; under torch 2.11.0+cu128 on an H100 every launch
of the port's reads, its own kernels' and torch's, is a
``cudaLaunchKernel``.  None where the run has no device events or no read
range."""

from portbench.bench import spanwalk as W

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


def read(run, name):
    if not run.dev_events:
        return None
    host = run.host_events
    reads = W.ranges(host, "client.read".__eq__, run.slice_lo, run.slice_hi)
    if not reads:
        return None
    engine = W.inside(host, lambda n: n.startswith("engine."), reads)
    launches = W.inside(host, lambda n: n.startswith(LAUNCHES), engine)
    return len(launches) / len(reads)
