"""Assigned-architecture configs (exact figures from the assignment).

``get_config(arch_id)`` resolves any of the ten ids; ``ARCH_IDS`` lists
them.  Shape cells (``repro.configs.shapes``) are not ported yet.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "qwen3-32b",
    "h2o-danube-3-4b",
    "olmo-1b",
    "qwen1.5-32b",
    "recurrentgemma-2b",
    "olmoe-1b-7b",
    "granite-moe-1b-a400m",
    "xlstm-350m",
    "internvl2-76b",
    "seamless-m4t-large-v2",
]

_MODULES: Dict[str, str] = {
    "qwen3-32b": "qwen3_32b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "olmo-1b": "olmo_1b",
    "qwen1.5-32b": "qwen15_32b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "xlstm-350m": "xlstm_350m",
    "internvl2-76b": "internvl2_76b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
