"""Model-layout wrappers over the port's kernels, each with a launch
count (mirrors :mod:`repro.kernels.ops`).

A tensor on the CPU goes to the kernel's plain version; a CUDA tensor
launches the CUDA kernel or raises — there is no fallback. Each wrapper
carries a plain integer ``launches`` that it raises by one where it
launches its kernel and nowhere else, so a run can show that its main
path went through the kernels (``reset_launches`` / ``launch_counts``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_attention import (paged_attention as
                                                 _paged_attention_kernel,
                                                 paged_attention_plain)


def _on_cpu(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{what}: no kernel for device {t.device}")


def attention(q, k, v, *, causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Model-layout attention. q: (B, S, Hq, D); k, v: (B, T, Hkv, D)
    -> (B, S, Hq, D). The kernel reads and writes the model layout
    through strided (B, H, S, D) views: no transposed copies."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if _on_cpu(q, "attention"):
        return flash_attention_plain(qt, kt, vt, causal=causal,
                                     window=window).transpose(1, 2)
    out = torch.empty_like(q)
    flash_attention(qt, kt, vt, causal=causal, window=window,
                    out=out.transpose(1, 2))
    attention.launches += 1
    return out


def paged_attention(q, k_pages, v_pages, page_table, pos) -> torch.Tensor:
    """Paged decode attention. q: (B, Hq, D); pages (NP, P, Hc, D);
    page_table (B, M) int32; pos (B,) int32 -> (B, Hq, D)."""
    if _on_cpu(q, "paged_attention"):
        return paged_attention_plain(q, k_pages, v_pages, page_table, pos)
    out = _paged_attention_kernel(q, k_pages, v_pages, page_table, pos)
    paged_attention.launches += 1
    return out


attention.launches = 0
paged_attention.launches = 0

WRAPPERS = {"flash_attention": attention, "paged_attention": paged_attention}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
