"""Architecture configs of the port (``repro.configs`` counterpart).

Each module defines ``CONFIG`` (the full published config) and ``SMOKE`` (a
reduced config of the same family for CPU tests), field for field the JAX
package's, under the same ids and public aliases.
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "jamba_1_5_large_398b",
    "mamba2_370m",
    "qwen1_5_110b",
    "starcoder2_15b",
    "mistral_nemo_12b",
    "granite_8b",
    "internvl2_2b",
    "whisper_base",
    "phi3_5_moe_42b",
    "deepseek_v2_236b",
]

# accept the dashed / dotted public ids too
ALIASES = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "mamba2-370m": "mamba2_370m",
    "qwen1.5-110b": "qwen1_5_110b",
    "starcoder2-15b": "starcoder2_15b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "granite-8b": "granite_8b",
    "internvl2-2b": "internvl2_2b",
    "whisper-base": "whisper_base",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "deepseek-v2-236b": "deepseek_v2_236b",
}


def _module(name: str):
    name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).SMOKE
