"""scan_fused_roofline: the scan kernel's share of its roofline.  The bytes
the scan needs on the last profiled successor_k batch (the frozen
`scan_needs`, each distinct byte once), over 3.35 TB/s, divided by the
profiler's time of the scan kernel that read it.  Where the window
inserts, the bytes are counted on the tree after that step's inserts,
not before them: a step's inserts are a few dozen keys among millions."""

import torch

from portbench.bench import roofline as R

KERNEL = "scan_fused_kernel"
KEY_MAX = 2**31 - 2       # the key domain's top: successors are unbounded


def capture(ctx):
    cfg = ctx.run_config["index"]
    t = ctx.ix.state
    i = ctx.last_step
    bits = int(cfg["payload_bits"])
    pmask = (1 << bits) - 1 if bits else 0
    q = ctx.stream.reads(i).to(ctx.device, torch.int64)
    his = torch.full_like(q, KEY_MAX)
    if bits:
        q, his = (q << bits) | pmask, (his << bits) | pmask
    q, his = q.to(t.value.dtype), his.to(t.value.dtype)
    roots = torch.full_like(q, int(t.root), dtype=torch.int32)
    return R.scan_needs(t, int(cfg["height"]), roots, q, his,
                        ctx.stream.k, pmask, max_rounds=1 << 20)


def read(run, name):
    return R.kernel_share(run, run.captures.get(name), KERNEL)
