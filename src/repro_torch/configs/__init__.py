"""Config registry of the port (mirrors :mod:`repro.configs`).

Only the architectures the port can serve are registered;
``get_config(arch_id, reduced)`` returns the full configuration or its
smoke-test variant, copied as data from ``repro``'s config modules.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

_MODULES: Dict[str, str] = {
    "granite-3-2b": "granite_3_2b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str, reduced: bool = False):
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet; ported: "
            f"{ARCH_IDS} (other families are queued in ROADMAP.md)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.REDUCED if reduced else mod.CONFIG
