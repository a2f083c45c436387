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

    @property
    def greedy(self) -> bool:
        return self.method == "greedy"

    def sample(self, logits: torch.Tensor, rids: torch.Tensor,
               idxs: torch.Tensor) -> torch.Tensor:
        """One token per row: (B, V) logits, (B,) request ids and 0-based
        output token indices -> (B,) int32. Greedy ignores the keys and
        takes the argmax (first index on ties, as ``jnp.argmax``); the keys
        are the (rid, token index) a sampled draw would fold into its
        seed, as in ``repro``."""
        return torch.argmax(logits, dim=-1).to(torch.int32)
