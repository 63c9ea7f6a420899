"""maint.syncs_per_update: host-device round trips an update call makes:
the CUDA runtime calls that wait for the device inside each
``maint.batch`` range of the profiled stretch, per such range.

The calls: ``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize`` and the blocking ``cudaMemcpy``.  Under torch
2.11.0+cu128 on an H100 the profiler records an ``.item()`` or a
``.tolist()`` as ``cudaMemcpyAsync`` then ``cudaStreamSynchronize``, and
``torch.nonzero`` as four ``cudaLaunchKernel``, a ``cudaMemcpyAsync`` and
a ``cudaStreamSynchronize``: one wait each.  A ``cudaMemcpyAsync``
to or from pageable memory with no wait after it is not counted.  None
where the run has no device events or no ``maint.batch`` range."""

from portbench.bench import spanwalk as W

SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"))


def read(run, name):
    if not run.dev_events:
        return None
    host = run.host_events
    batches = W.ranges(host, "maint.batch".__eq__, run.slice_lo,
                       run.slice_hi)
    if not batches:
        return None
    return len(W.inside(host, SYNCS.__contains__, batches)) / len(batches)
