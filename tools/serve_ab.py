#!/usr/bin/env python3
"""Granite-8B serve times (``chip_smoke.py`` phase 5.3-5.4) of two checkouts
of the port on one card, in one run.

    python3 tools/serve_ab.py --base DIR [--pairs 2] [--seed 0] [--out FILE]

DIR is another checkout's root (for instance the parent commit unpacked
with ``git archive`` into the git-ignored ``build/``).  Each version runs
in its own process, ``--pairs`` pairs of them with the first of a pair
alternating (base, this, this, base, ...), so that a drift of the host's
speed falls on both alike.  A process imports its checkout's
``chip_smoke.py`` and port, builds the kernels, and runs that checkout's
``full_width_serve`` (the 36-layer bf16 Granite-8B drawn on the card from
the seed, 16 requests with 8 live lanes and every request held to the
dense decode, three traced steps, then the churn trace under deferred).
Prints one JSON line a process, then for each time the medians over each
version's processes, the base's spread (the distance between its
quartiles) and the pairs this checkout won; ``--out`` writes them all.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TIMES = ("decode_step_ms", "decode_tok_s", "tok_s", "prefill_ms", "lookup_ms",
         "busy_ms", "untraced_step_ms", "churn_decode_step_ms")


def child(root: Path, seed: int) -> dict:
    """One process: the serve times of the checkout at ``root``."""
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(root))
    import numpy as np
    import torch

    import chip_smoke as CS
    import repro_torch

    assert Path(repro_torch.__file__).resolve().is_relative_to(root.resolve())
    CS.card_check()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = CS.full_width_serve(np.random.default_rng(seed + 5),
                              torch.device("cuda"), seed)
    s, dev = out["serve"], out["serve"]["device_ms"]
    return dict(root=str(root), decode_step_ms=s["decode_step_ms"],
                decode_tok_s=s["decode_tok_s"], tok_s=s["tok_s"],
                prefill_ms=s["prefill_ms"], lookup_ms=s["lookup_ms"],
                busy_ms=dev["busy"], untraced_step_ms=dev["untraced_step_ms"],
                churn_decode_step_ms=out["churn"]["decode_step_ms"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--child", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child, args.seed)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or args.base is None:
        print("serve_ab: needs a CUDA card and --base", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    order = [("base", args.base), ("this", ROOT)]
    runs = []
    for name, root in (order[(i + j) % 2] for i in range(args.pairs)
                       for j in range(2)):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, __file__, "--child", str(root),
                              "--seed", str(args.seed)], capture_output=True,
                             text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        row = dict(json.loads(out.stdout.strip().splitlines()[-1]),
                   version=name, seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
        runs.append(row)
    summary = {}
    for c in TIMES:
        base = [r[c] for r in runs if r["version"] == "base"]
        this = [r[c] for r in runs if r["version"] == "this"]
        q = statistics.quantiles(base, n=4) if len(base) > 1 else [0, 0, 0]
        better = (lambda t, b: t > b) if c.endswith("tok_s") else \
            (lambda t, b: t < b)
        summary[c] = dict(base=statistics.median(base),
                          this=statistics.median(this),
                          base_spread=q[2] - q[0],
                          pairs_won=sum(better(t, b) for b, t in
                                        zip(base, this)),
                          pairs=len(base))
        print(json.dumps({"summary": c, **summary[c]}))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs,
                                        "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
