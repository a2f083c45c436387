"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``"cuda"`` (the default everywhere) raises when no card is visible:
    the port never falls back to the CPU on its own. Only an explicit
    ``device="cpu"`` runs there, as the tests do.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run on the CPU")
        # Full float32 products on the card: the reduced configs are
        # float32 and their tolerances (atol 2e-5 / 1e-4 against repro)
        # assume IEEE float32, which TF32's ~3 decimal digits would break.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or "
                         f"'cpu'")
    return dev
