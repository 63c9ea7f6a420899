"""device.idle_share: 1 - device busy / wall over the profiled stretch;
busy is the union of every device interval of the trace in it."""


def read(run, name):
    return 1.0 - run.busy_s / run.slice_s if run.busy_s > 0 else None
