"""walk_fused_roofline: the fused walk kernel's share of its roofline.  The
bytes the walk needs on the last profiled read batch (the frozen
`fused_needs`, each distinct byte once), over 3.35 TB/s, divided by the
profiler's time of the walk kernel that read it.  Where the window
updates, the bytes are counted on the tree after that step's updates,
not before them: a step's updates are some hundred keys among
millions."""

import torch

from portbench.bench import roofline as R

KERNEL = "walk_fused_kernel"


def capture(ctx):
    cfg = ctx.run_config["index"]
    t = ctx.ix.state
    q = ctx.stream.reads(ctx.last_step).to(ctx.device, torch.int64)
    bits = int(cfg["payload_bits"])
    if bits:
        q = (q << bits) | ((1 << bits) - 1)
    q = q.to(t.value.dtype)
    roots = torch.full_like(q, int(t.root), dtype=torch.int32)
    return R.fused_needs(t, int(cfg["height"]), q, roots,
                         max_rounds=1 << 16)


def read(run, name):
    return R.kernel_share(run, run.captures.get(name), KERNEL)
