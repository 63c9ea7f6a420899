"""Roofline terms of a counted step (port of ``repro.analysis.roofline``).

Every quantity is per card, as in the JAX module:

  compute term    = flops / peak bf16 FLOP/s
  memory term     = bytes accessed / HBM bytes/s
  collective term = wire bytes / NVLink bytes/s

The constants are the card's row (`launch.mesh.card`), not a TPU's.
`collective_stats` is JAX's with the same ring formulas and output
schema, read from `parallel.comm`'s records of the step instead of from
HLO text (a record's bytes are what JAX reads off the HLO line: an
all-reduce's operand, an all-gather's result, a reduce-scatter's
block):

  all-reduce        2 * bytes * (n-1)/n
  all-gather            bytes * (n-1)/n
  reduce-scatter        bytes * (n-1)
  all-to-all            bytes * (n-1)/n
  collective-permute    bytes

A record of another kind (the checkpoint's ``gather``) is not counted:
JAX's parser knows only these five.  A step on one card has no
collective: `no_collectives` is that case.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.launch.mesh import Card

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


def no_collectives() -> dict:
    """The JAX record's ``collectives`` for a program with none."""
    return collective_stats(())


def _wire(kind: str, nbytes: int, n: int) -> float:
    if kind == "all-reduce":
        return 2 * nbytes * (n - 1) / n
    if kind in ("all-gather", "all-to-all"):
        return nbytes * (n - 1) / n
    if kind == "reduce-scatter":
        return nbytes * (n - 1)
    return float(nbytes)


def collective_stats(records) -> dict:
    """Per-device wire bytes by collective kind of ``records`` (each with
    ``kind``, ``nbytes`` and ``group_size``, `parallel.comm.Record`), in
    JAX's schema."""
    out = dict.fromkeys(COLLECTIVE_KINDS, 0.0)
    counts = dict.fromkeys(COLLECTIVE_KINDS, 0)
    for r in records:
        if r.kind not in out:
            continue
        out[r.kind] += _wire(r.kind, r.nbytes, r.group_size)
        counts[r.kind] += 1
    return {"wire_bytes": out, "counts": counts,
            "total_wire_bytes": sum(out.values())}


@dataclass
class Roofline:
    flops: float            # per device
    hbm_bytes: float        # per device
    wire_bytes: float       # per device
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_per_device: float
    useful_flops_ratio: float

    def as_dict(self):
        return self.__dict__.copy()


def roofline_terms(cost: dict, coll: dict, model_flops_global: float,
                   n_chips: int, card: Card) -> Roofline:
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    wire = float(coll["total_wire_bytes"])
    terms = {
        "compute": flops / card.PEAK_FLOPS_BF16,
        "memory": hbm / card.HBM_BW,
        "collective": wire / card.ICI_BW,
    }
    bottleneck = max(terms, key=terms.get)
    mf = model_flops_global / n_chips
    return Roofline(
        flops=flops, hbm_bytes=hbm, wire_bytes=wire,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"], bottleneck=bottleneck,
        model_flops_per_device=mf,
        useful_flops_ratio=(mf / flops) if flops else 0.0,
    )


def model_flops(cfg, shape_kind: str, n_tokens: int, n_params: int,
                n_active_params: int) -> float:
    """6·N_active·D train, 2·N_active·D inference (N_active = N for dense
    archs)."""
    if shape_kind == "train":
        return 6.0 * n_active_params * n_tokens
    return 2.0 * n_active_params * n_tokens


def active_params(cfg, n_params: int) -> int:
    """Subtract non-routed expert weights for MoE archs."""
    if not cfg.moe_experts:
        return n_params
    moe_layers = sum(
        1 for i in range(cfg.num_layers) if cfg.ffn_kind(i) == "moe"
    )
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    unused = moe_layers * per_expert * (cfg.moe_experts - cfg.moe_top_k)
    return n_params - unused
