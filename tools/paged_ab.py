#!/usr/bin/env python3
"""Kernel 4 (``csrc/paged_attention.cu``) of two checkouts, timed in turns
on one card.

    python3 tools/paged_ab.py --base DIR [--pairs 10] [--reps 20] [--seed 0]
                              [--out FILE]

DIR is another checkout's root (for instance the parent commit unpacked
with ``git archive`` into the git-ignored ``build/``).  Both sources are
built with the port's nvcc flags (into ``build/paged_ab/``) and called
through this checkout's wrapper (`delta_paged_attention`), whose C
interface they share, on the same inputs: ``chip_smoke.paged_case`` at
Granite-8B's heads (32 / 8, D = 128, PS = 16) in bf16 and float32, at
the served batch (B = 8, lengths drawn in 512..1536 as phase 5.1 draws
them) and at B = 64 x 4096.  Both outputs are first held against the
plain version (`chip_smoke.paged_err`).  Then ``--pairs`` pairs of
CUDA-event windows of ``--reps`` launches each (L2 flushed between
launches), the first of a pair alternating (base, this, this, base, ...).
Prints one JSON line a cell: each version's median, the base's spread
(the distance between its quartiles) and the pairs this checkout won.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CELLS = ((8, 1024), (64, 4096))       # (B, tokens): chip_smoke's PA_SERVED, PA_LONG


def build(source: Path, out: Path) -> ctypes.CDLL:
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path

    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(source)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def quartile_spread(xs) -> float:
    q = statistics.quantiles(xs, n=4)
    return q[2] - q[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, required=True)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as CS
    from repro_torch.kernels import delta_paged_attention as TPA
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        print("paged_ab: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    rel = "src/repro_torch/kernels/csrc/paged_attention.cu"
    libs = {"base": build(args.base / rel, ROOT / "build/paged_ab/base.so"),
            "this": build(ROOT / rel, ROOT / "build/paged_ab/this.so")}
    own = TPA._kernel_fn

    def use(name: str) -> None:
        def fn(dtype):
            f = getattr(libs[name], f"paged_decode_attention_"
                                    f"{TPA._SUFFIX[dtype]}")
            f.argtypes, f.restype = TPA._ARGS, ctypes.c_int
            return f
        TPA._kernel_fn = fn

    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for b, tokens in CELLS:
            lens = (rng.integers(tokens // 2, 3 * tokens // 2 + 1, b)
                    if b == CELLS[0][0] else np.full(b, tokens))
            a = CS.paged_case(gen, rng, device, dtype, lens, scramble=False)
            want = ref.ref_paged_decode_attention(*a)
            for name in libs:
                use(name)
                err, ok = CS.paged_err(TPA.paged_decode_attention(*a), want)
                CS.check(ok, f"{name} != plain at B = {b}, {dtype}: {err}")
            times = {name: [] for name in libs}
            wins = 0
            for p in range(args.pairs):
                order = ("base", "this") if p % 2 == 0 else ("this", "base")
                got = {}
                for name in order:
                    use(name)
                    got[name] = CS.cuda_ms(
                        lambda: TPA.paged_decode_attention(*a), args.reps,
                        flush)
                    times[name].append(got[name])
                wins += got["this"] < got["base"]
            nbytes = CS.paged_bytes(a[0], a[1], a[3], a[4])
            row = dict(B=b, tokens=int(lens.sum()), dtype=str(dtype)[6:],
                       base_ms=statistics.median(times["base"]),
                       this_ms=statistics.median(times["this"]),
                       base_spread_ms=quartile_spread(times["base"]),
                       this_wins=wins, pairs=args.pairs,
                       bound_ms=CS.bound_ms(nbytes), base=times["base"],
                       this=times["this"])
            print(json.dumps(row), flush=True)
            rows.append(row)
            del a, want
            torch.cuda.empty_cache()
    TPA._kernel_fn = own
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
