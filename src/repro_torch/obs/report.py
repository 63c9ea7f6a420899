"""Render and diff consolidated ``BENCH_*.json`` files (the port's own copy
of ``repro.obs.report``, which it may not import).

``benchmarks/run.py`` consolidates every row of a run into one JSON file
(``{"timestamp", "args", "meta", "rows"}``); this CLI turns those files
into something a human can read across PRs::

    python -m repro_torch.obs.report BENCH_NEW.json                 # tables
    python -m repro_torch.obs.report BENCH_NEW.json --diff OLD.json # + deltas
    python -m repro_torch.obs.report NEW.json --diff OLD.json --out report.md

The diff matches rows by their identity fields (suite/backend/engine/...)
— tolerantly, so files written by different schema generations still
pair up (a key missing on one side is a wildcard) — and reports a
speedup factor per pair on the row's primary metric (``ops_per_s``
higher-better; ``*_us``/``seconds``/``loads`` lower-better).  Pairs
below ``--threshold`` are flagged as regressions;
``--fail-on-regression`` turns flags into a non-zero exit (off by
default: CI smoke numbers are noisy by design and only the rendered
artifact is meant for eyes).

stdlib-only on purpose: the CLI must render a report without importing
torch (fast, and usable on machines that only have the JSON files).
"""

from __future__ import annotations

import argparse
import json
import sys

# Row fields that identify *what* was measured (matched in the diff) —
# everything else is either a measurement or an execution-mode stamp.
ID_KEYS = [
    "suite", "bench", "backend", "engine", "dispatch", "walk",
    "maintenance", "update_pct", "batch", "ub", "height", "shards",
    "devices", "q_tile", "flush_every", "initial_keys", "seed", "skipped",
    "density", "max_items",
]

# Execution-mode stamps: describe the machine, not the workload.
META_KEYS = ["device_kind", "interpret", "x64", "jax_version"]

# Lower-is-better metrics; anything else numeric is higher-is-better.
LOWER_BETTER = {
    "seconds", "compile_seconds", "paged_step_us", "dense_step_us",
    "p50_us", "p99_us", "loads", "blocks_b16", "blocks_b128",
    "hops", "hops_mean", "hops_max", "hops_per_search", "rounds",
    "inline_maint", "admit_wait", "queue_hwm", "walk_launches",
}

# Primary metric per row, first present wins (name, higher_is_better).
PRIMARY = [("ops_per_s", True), ("scans_per_s", True),
           ("paged_step_us", False), ("loads", False), ("seconds", False)]


def load(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, list):  # bare row list (hand-rolled files)
        data = {"timestamp": "?", "args": {}, "rows": data}
    return data


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    if isinstance(v, list):
        s = ",".join(_fmt(x) for x in v)
        return "[" + (s if len(s) <= 18 else s[:15] + "...") + "]"
    if v is None:
        return "-"
    return str(v)


def _table(rows: list[dict], cols: list[str]) -> list[str]:
    cells = [[_fmt(r.get(c)) for c in cols] for r in rows]
    widths = [max([len(c)] + [len(row[i]) for row in cells])
              for i, c in enumerate(cols)]
    out = ["  ".join(c.ljust(w) for c, w in zip(cols, widths)).rstrip()]
    out.append("  ".join("-" * w for w in widths))
    out.extend("  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip()
               for row in cells)
    return out


def _suite_cols(rows: list[dict]) -> list[str]:
    present: list[str] = []
    for r in rows:
        for k in r:
            if k not in present:
                present.append(k)
    ids = [k for k in ID_KEYS if k in present and k != "suite"]
    metrics = [k for k in present
               if k not in ID_KEYS and k not in META_KEYS]
    return ids + metrics


def by_suite(rows: list[dict]) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}
    for r in rows:
        out.setdefault(str(r.get("suite", "unknown")), []).append(r)
    return out


def render(bench: dict, title: str = "") -> list[str]:
    lines = []
    if title:
        lines.append(f"# {title}")
    meta = bench.get("meta") or {}
    stamp = ", ".join(f"{k}={_fmt(meta[k])}" for k in META_KEYS if k in meta)
    args = bench.get("args") or {}
    lines.append(f"timestamp: {bench.get('timestamp', '?')}"
                 + (f"  ({stamp})" if stamp else ""))
    if args:
        lines.append("args: " + json.dumps(args, sort_keys=True))
    for suite, rows in sorted(by_suite(bench["rows"]).items()):
        lines.append("")
        lines.append(f"## {suite} ({len(rows)} rows)")
        lines.extend(_table(rows, _suite_cols(rows)))
    return lines


# ---------------------------------------------------------------- diff ---


def _row_label(r: dict) -> str:
    return " ".join(
        _fmt(r[k]) for k in ("bench", "backend", "engine", "dispatch",
                             "maintenance", "update_pct", "batch", "ub",
                             "height", "shards", "density", "max_items")
        if r.get(k) is not None) or "(row)"


def _primary_one(row: dict):
    for name, _higher in PRIMARY:
        v = row.get(name)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return name, float(v)
    return None


def history(benches: list[dict]) -> list[str]:
    """Per-suite trajectory tables across many BENCH files: one row per
    measured identity, one column per timestamp, cells the row's primary
    metric — the at-a-glance perf record across committed artifacts."""
    benches = sorted(benches, key=lambda b: str(b.get("timestamp", "?")))
    stamps: list[str] = []
    for b in benches:
        ts = str(b.get("timestamp", "?"))
        while ts in stamps:  # duplicate stamps still get a column each
            ts += "'"
        stamps.append(ts)
    suites: dict[str, dict[str, dict]] = {}
    for b, ts in zip(benches, stamps):
        for suite, rows in by_suite(b.get("rows", [])).items():
            per = suites.setdefault(suite, {})
            for r in rows:
                p = _primary_one(r)
                if p is None:
                    continue
                name, v = p
                cell = per.setdefault(_row_label(r), {"metric": name})
                cell[ts] = v
    lines = [f"# history across {len(benches)} files"]
    for suite in sorted(suites):
        table = [{"row": label, **cells}
                 for label, cells in sorted(suites[suite].items())]
        if not table:  # no row in the suite carried a primary metric
            continue
        lines.append("")
        lines.append(f"## {suite} ({len(table)} rows)")
        lines.extend(_table(table, ["row", "metric"] + stamps))
    return lines


def _match(new_row: dict, base_rows: list[dict]) -> dict | None:
    """Base row whose identity agrees with ``new_row`` on every ID key
    present in *both* rows (schema-generation tolerant); None when the
    match is absent or ambiguous."""
    hits = []
    for b in base_rows:
        shared = [k for k in ID_KEYS if k in new_row and k in b]
        if shared and all(new_row[k] == b[k] for k in shared):
            hits.append(b)
    return hits[0] if len(hits) == 1 else None


def _primary(new_row: dict, base_row: dict):
    for name, higher in PRIMARY:
        a, b = new_row.get(name), base_row.get(name)
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            return name, higher, float(a), float(b)
    return None


def diff(new: dict, base: dict, threshold: float = 0.9):
    """Pairwise speedups new-vs-base.  Returns (lines, regressions)."""
    lines, regressions = [], []
    base_by = by_suite(base["rows"])
    for suite, rows in sorted(by_suite(new["rows"]).items()):
        pool = list(base_by.get(suite, []))
        pairs, unmatched = [], 0
        for r in rows:
            b = _match(r, pool)
            if b is None:
                unmatched += 1
                continue
            pool.remove(b)  # a base row pairs at most once
            p = _primary(r, b)
            if p is None:
                continue
            name, higher, av, bv = p
            if min(av, bv) <= 0:
                continue
            speedup = (av / bv) if higher else (bv / av)
            label = " ".join(
                _fmt(r[k]) for k in ("backend", "engine", "dispatch",
                                     "maintenance", "update_pct", "batch",
                                     "ub")
                if r.get(k) is not None)
            flag = ""
            if speedup < threshold:
                flag = "  << REGRESSION"
                regressions.append((suite, label, name, speedup))
            pairs.append({"row": label, "metric": name,
                          "base": _fmt(bv), "new": _fmt(av),
                          "speedup": f"{speedup:.3f}x{flag}"})
        lines.append("")
        lines.append(f"## {suite}: {len(pairs)} matched"
                     + (f", {unmatched} unmatched" if unmatched else ""))
        if pairs:
            lines.extend(_table(pairs,
                                ["row", "metric", "base", "new", "speedup"]))
    return lines, regressions


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="render / diff consolidated BENCH_*.json files")
    ap.add_argument("bench", nargs="+",
                    help="BENCH_*.json to render (several with --history)")
    ap.add_argument("--diff", default=None, metavar="BASE",
                    help="baseline BENCH_*.json to diff against")
    ap.add_argument("--history", action="store_true",
                    help="render a per-suite trajectory table across all "
                         "given files (primary metric per timestamp)")
    ap.add_argument("--threshold", type=float, default=0.9,
                    help="speedup below this flags a regression (0.9)")
    ap.add_argument("--out", default=None,
                    help="also write the rendered report to this path")
    ap.add_argument("--fail-on-regression", action="store_true",
                    help="exit 1 when any pair regresses past --threshold")
    args = ap.parse_args(argv)

    if args.history:
        text = "\n".join(history([load(p) for p in args.bench])) + "\n"
        sys.stdout.write(text)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        return 0
    if len(args.bench) > 1:
        ap.error("multiple BENCH files need --history")
    new = load(args.bench[0])
    lines = render(new, title=f"bench report: {args.bench[0]}")
    regressions = []
    if args.diff:
        base = load(args.diff)
        lines.append("")
        lines.append(f"# diff vs {args.diff} "
                     f"(timestamp {base.get('timestamp', '?')})")
        dl, regressions = diff(new, base, threshold=args.threshold)
        lines.extend(dl)
        lines.append("")
        lines.append(f"regressions (<{args.threshold}x): {len(regressions)}")
    text = "\n".join(lines) + "\n"
    sys.stdout.write(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 1 if (regressions and args.fail_on_regression) else 0


if __name__ == "__main__":
    raise SystemExit(main())
