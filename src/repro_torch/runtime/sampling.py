"""Token selection for the serving runtime (port of
:mod:`repro.runtime.sampling`, greedy only).

``repro`` keys each sampled token with JAX ``fold_in`` of (seed, rid,
token index), which torch cannot reproduce bit for bit; sampled decoding
is a later item (ROADMAP.md), so ``sampling.method="sample"`` raises.
"""
from __future__ import annotations

import torch


class TokenSampler:
    """A SamplingSpec bound to callable form for the engines."""

    def __init__(self, spec=None):
        self.method = getattr(spec, "method", "greedy")
        if self.method != "greedy":
            raise NotImplementedError(
                f"sampling.method={self.method!r} is not ported to "
                f"repro_torch yet; only greedy decoding is (see ROADMAP.md)")

    def sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy pick: (B, V) logits -> (B,) int32 argmax (first index on
        ties, as ``jnp.argmax``)."""
        return torch.argmax(logits, dim=-1).to(torch.int32)
