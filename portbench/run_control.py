#!/usr/bin/env python3
"""The control of a cell: the plain reference put in the program's place,
its keys compared at the lower precision the configuration names
(``control.key_dtype``), driven by the same client over the same traffic
and judged by the same comparison.  It has to come out not correct.

    python3 portbench/run_control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

One JSON line a seed: the seed, ``correct`` and each number compared.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).parent:
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from portbench.bench import cells, runner, system

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = cells.load_bench(ROOT)
    cell = cells.by_name(bench["workloads"], args.workload, "workload")
    config = cells.load_config(bench, cell["config"], ROOT)
    dtype = getattr(torch, config["control"]["key_dtype"])
    for seed in args.seeds:
        out = runner.run_cell(
            args.workload, seed, args.seconds, False, bench=bench, root=ROOT,
            replace=lambda ds: system.ReferenceSystem(ds, "cuda", dtype))
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "key_dtype": str(dtype), "checks": out["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
