"""Architecture configs of the port (``repro.configs`` counterpart).

Each module defines ``CONFIG`` (the full published config) and ``SMOKE`` (a
reduced config of the same family for CPU tests), field for field the JAX
package's.  Only the architectures the port runs are here: the dense, MoE
and VLM families the serve path admits.  ``get_config`` of any other
(DeepSeek-V2's MLA, Mamba2's and Jamba's SSD, Whisper's encoder-decoder)
raises and names ROADMAP.md.
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "qwen1_5_110b",
    "starcoder2_15b",
    "mistral_nemo_12b",
    "granite_8b",
    "internvl2_2b",
    "phi3_5_moe_42b",
]

# accept the dashed / dotted public ids too
ALIASES = {
    "qwen1.5-110b": "qwen1_5_110b",
    "starcoder2-15b": "starcoder2_15b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "granite-8b": "granite_8b",
    "internvl2-2b": "internvl2_2b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
}


def _module(name: str):
    name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported to repro_torch (see "
            f"ROADMAP.md, Queue 1); ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).SMOKE
