"""setup_s: from the start of the process until the window opens: imports,
the card's context, the data and the traffic drawn from the seed, the
index built, the kernels loaded (built, in a checkout's first run) and
the warm-up steps."""


def read(run, name):
    return run.setup_s
