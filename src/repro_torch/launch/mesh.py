"""Hardware constants of the card the port runs on (port of the constants at
the end of ``repro.launch.mesh``), under the JAX module's names.

The JAX module's constants are a TPU v5e's; none is carried over.  Each
row here is keyed by the name ``nvidia-smi --query-gpu=name`` prints for
the card, and its numbers come from the vendor's data sheet (dense rates,
no sparsity, at the card's full power limit):

- NVIDIA H100 SXM5 80 GB ("NVIDIA H100 80GB HBM3", 700 W): 989 TFLOP/s
  dense bf16, 3.35 TB/s of HBM3, 80 GB, NVLink 4 at 900 GB/s a card
  both ways together, so 450 GB/s each way (``ICI_BW``: what one card
  sends to the others).

`card(name)` returns the row; an unknown card raises.  The JAX module's
meshes (``make_production_mesh``, ``make_host_mesh``,
``make_forest_mesh``) are not ported: the port runs on one card until the
multi-card slice (ROADMAP Queue 1 item 3), which brings them with
``torch.distributed``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Card:
    name: str               # as nvidia-smi --query-gpu=name prints it
    PEAK_FLOPS_BF16: float  # dense bf16 FLOP/s
    HBM_BW: float           # bytes/s of device memory
    HBM_PER_CHIP: float     # bytes of device memory
    ICI_BW: float           # bytes/s a card sends over NVLink


H100_SXM = Card(name="NVIDIA H100 80GB HBM3", PEAK_FLOPS_BF16=989e12,
                HBM_BW=3.35e12, HBM_PER_CHIP=80e9, ICI_BW=450e9)

CARDS = {c.name: c for c in (H100_SXM,)}


def card(name: str | None = None) -> Card:
    """The row of the card ``name``; with None, of the card present
    (``torch.cuda.get_device_name(0)``).  Raises when the card has no row,
    or when there is no card and no name."""
    if name is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present: name the card's row (one of "
                f"{sorted(CARDS)})")
        name = torch.cuda.get_device_name(0)
    try:
        return CARDS[name]
    except KeyError:
        raise KeyError(f"no constants for the card {name!r}; known: "
                       f"{sorted(CARDS)}") from None
