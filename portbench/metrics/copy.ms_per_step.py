"""copy.ms_per_step: device time of the host<->device copies (batches in,
answers out) a step, from the profiled stretch's trace."""


def read(run, name):
    lo, hi = run.slice_lo, run.slice_hi
    us = sum(e - s for s, e, n in run.dev_events
             if n.startswith("Memcpy") and ("HtoD" in n or "DtoH" in n)
             and lo <= s <= hi)
    return us / 1e3 / run.profiled_steps
