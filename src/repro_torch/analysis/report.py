"""Render the dry-run's tables (§Dry-run / §Roofline) from results/dryrun
(the port's copy of ``repro.analysis.report``, stdlib only).

    PYTHONPATH=src python -m repro_torch.analysis.report

The tables are the JAX module's, line for line; the port's records carry
the mesh ``card1`` (one card), and their ``compile_s`` is the host
seconds of the meta count (`launch.dryrun`)."""

from __future__ import annotations

import json
from pathlib import Path


def load(outdir="results/dryrun"):
    recs = []
    for p in sorted(Path(outdir).glob("*.json")):
        recs.append(json.loads(p.read_text()))
    return recs


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def fmt_s(x):
    if x is None:
        return "-"
    if x < 1e-3:
        return f"{x*1e6:.1f}µs"
    if x < 1:
        return f"{x*1e3:.2f}ms"
    return f"{x:.2f}s"


def dryrun_table(recs, mesh="card1") -> str:
    lines = [
        "| arch | shape | status | compile | bytes/dev (args+temp) | "
        "collectives (AR/AG/RS/A2A/CP) |",
        "|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | SKIP: "
                         f"{r['reason'][:48]} | - | - | - |")
            continue
        if r["status"] == "error":
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR "
                         f"{r['error'][:60]} | - | - | - |")
            continue
        mem = r["memory"]
        cc = r["collectives"]["counts"]
        coll = (f"{cc['all-reduce']}/{cc['all-gather']}/"
                f"{cc['reduce-scatter']}/{cc['all-to-all']}/"
                f"{cc['collective-permute']}")
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['compile_s']}s | "
            f"{fmt_bytes(mem['argument_size_bytes'])}+"
            f"{fmt_bytes(mem['temp_size_bytes'])} | {coll} |")
    return "\n".join(lines)


def roofline_table(recs, mesh="card1") -> str:
    lines = [
        "| arch | shape | compute | memory | collective | bottleneck | "
        "useful FLOPs | note |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh or r["status"] != "ok":
            continue
        rx = r.get("roofline_extrapolated") or r["roofline"]
        dom = rx["bottleneck"]
        note = {
            "compute": "more chips / faster matmul won't help others",
            "memory": "reduce bytes: fusion, remat policy, dtype",
            "collective": "reshard / overlap / compress",
        }[dom]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rx['compute_s'])} | "
            f"{fmt_s(rx['memory_s'])} | {fmt_s(rx['collective_s'])} | "
            f"**{dom}** | {rx['useful_flops_ratio']*100:.0f}% | {note} |")
    return "\n".join(lines)


def main():
    recs = load()
    for mesh in ("card1",):
        sub = [r for r in recs if r["mesh"] == mesh]
        if not sub:
            continue
        print(f"\n### Dry-run ({mesh})\n")
        print(dryrun_table(recs, mesh))
        print(f"\n### Roofline ({mesh})\n")
        print(roofline_table(recs, mesh))


if __name__ == "__main__":
    main()
