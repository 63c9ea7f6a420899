"""Int8 gradient / delta compression (port of ``repro.optim.compress``).

Per-tensor symmetric int8 quantization with a float32 scale.  The JAX
package uses it for the compressed cross-pod mean (``compressed_pmean``,
a collective); that needs a second card and is not ported yet.
"""

from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor):
    """(q int8, scale float32): ``x`` ~ q * scale, |q| <= 127."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
