"""Config registry of the port (mirrors :mod:`repro.configs`).

Only the architectures the port runs are registered (the LMs it serves
and trains, in ``repro``'s order, and the paper's CNN, which it trains);
``get_config(arch_id, reduced)`` returns the full configuration or its
smoke-test variant, copied as data from ``repro``'s config modules.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

_MODULES: Dict[str, str] = {
    "granite-3-2b": "granite_3_2b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen2-72b": "qwen2_72b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "llama3-8b": "llama3_8b",
    "zamba2-2.7b": "zamba2_2_7b",
    "internvl2-2b": "internvl2_2b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "whisper-tiny": "whisper_tiny",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "paper-cnn": "paper_cnn",
}

ARCH_IDS: List[str] = [k for k in _MODULES if k != "paper-cnn"]


def get_config(arch_id: str, reduced: bool = False):
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet; ported: "
            f"{sorted(_MODULES)} (other families are queued in "
            f"ROADMAP.md)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.REDUCED if reduced else mod.CONFIG
