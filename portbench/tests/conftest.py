"""The harness's own tests (run from the checkout's root:
``python -m pytest portbench/tests``).  A test marked ``requires_cuda``
skips where no card is present; the check runs inside a fixture, never
while a module is imported."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _requires_cuda(request):
    if request.node.get_closest_marker("requires_cuda"):
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
