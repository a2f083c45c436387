"""Config registry of the port (mirrors :mod:`repro.configs`).

Only the architectures the port runs are registered (the LMs it serves
and trains, and the paper's CNN, which it trains);
``get_config(arch_id, reduced)`` returns the full configuration or its
smoke-test variant, copied as data from ``repro``'s config modules.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

_MODULES: Dict[str, str] = {
    "granite-3-2b": "granite_3_2b",
    "falcon-mamba-7b": "falcon_mamba_7b",
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
