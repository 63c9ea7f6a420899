"""engine.hops_mean: the mean of the ``hops`` column the reads return
(ΔNodes a query visited: the paper's transfer count), over the traced
run's window."""


def read(run, name):
    return run.hops_mean
