"""Seeded token sampling for the serving runtime (port of
:mod:`repro.runtime.sampling`, bit for bit).

Sampled draws are keyed by ``(seed, rid, token_index)``: each emitted
token folds its request id and its 0-based output index into the spec
seed, then draws once from the (temperature / top-k / top-p filtered)
distribution. Because the key depends only on spec-level identity, the
same spec yields the same tokens across runs, across engines and across
preempt/resume boundaries, and the speculative engine's keyed coupling
holds (:mod:`repro_torch.runtime.spec_decode`).

``repro`` draws with JAX's default PRNG, Threefry-2x32, a pure function
on 32-bit integers. This module computes it in torch on int64 tensors
masked to 32 bits (torch's uint32 lacks shifts and xor on the card), so
the same code runs on the CPU and on CUDA and gives JAX's keys and bits
exactly: the key ``PRNGKey(seed)`` is ``[0, seed mod 2**32]`` (x64 off),
``fold_in(key, d)`` hashes the pair ``(0, d)`` under ``key``, and the
bits of a row of V are the hashes of ``(0, iota(V))`` xor-ed together.
The uniform and Gumbel transforms follow ``jax.random.uniform`` and
``jax.random.gumbel`` (mode "low"); a perturbed score's ``log`` may
round one float32 ulp apart from XLA's, so a token can differ from
``repro``'s only where the two best perturbed scores lie within a few
ulps of each other.

Greedy stays the plain argmax the engines always used: the
``reference_generate`` token-identity oracle is untouched by this module.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_FLOAT32_ONE = 0x3F800000                 # the bits of 1.0f
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counts ``(x0, x1)`` under the key
    ``(k0, k1)``: int64 tensors holding uint32 values, broadcast
    together. Returns the two output words, as JAX's ``threefry_2x32``."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: ``[0, seed mod
    2**32]`` as a (2,) int64 tensor."""
    return torch.tensor([0, int(seed) & _MASK32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` per row: ``key`` (..., 2), ``data`` (...)
    any integer dtype (taken mod 2**32, as JAX's uint32 cast). Returns
    the (..., 2) keys."""
    d = data.to(torch.int64) & _MASK32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, v: int) -> torch.Tensor:
    """``jax.random.bits(key, (v,))`` for each row of ``keys`` (B, 2):
    (B, v) int64 holding uint32 values. The counts are ``(0, iota(v))``
    and the output ``x0 ^ x1``: JAX's ``jax_threefry_partitionable``
    layout, on by default since JAX 0.5."""
    lo = torch.arange(v, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(lo),
                          lo)
    return y0 ^ y1


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 Gumbel noise from 32-bit draws, as ``jax.random.gumbel``
    (mode "low"): a uniform in [tiny, 1) from the top 23 bits, then
    ``-log(-log(u))``."""
    f = ((bits >> 9) | _FLOAT32_ONE).to(torch.int32).view(torch.float32)
    u = torch.clamp_min((f - 1.0) * (1.0 - _TINY) + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def filtered_logits(logits: torch.Tensor, *, temperature: float = 1.0,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None) -> torch.Tensor:
    """``repro``'s filters: float32 logits divided by the temperature
    (a true division, as XLA's; a CPU scalar divisor would make CUDA
    multiply by its reciprocal), then every entry below the k-th largest
    (ties at it kept) and below the nucleus threshold set to -1e30."""
    t = torch.tensor(float(temperature), dtype=torch.float32,
                     device=logits.device)
    lg = logits.float() / t
    v = lg.shape[-1]
    if top_k is not None and top_k < v:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = torch.where(lg < kth, _NEG_INF, lg)
    if top_p is not None and top_p < 1.0:
        srt = torch.sort(lg, dim=-1, descending=True).values
        e = torch.exp(srt - srt[:, :1])
        probs = e / e.sum(dim=-1, keepdim=True)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        thresh = torch.where(keep, srt, float("inf")).amin(dim=-1,
                                                           keepdim=True)
        lg = torch.where(lg < thresh, _NEG_INF, lg)
    return lg


def perturbed_scores(logits: torch.Tensor, rids: torch.Tensor,
                     idxs: torch.Tensor, *, temperature: float = 1.0,
                     top_k: Optional[int] = None,
                     top_p: Optional[float] = None,
                     seed: int = 0) -> torch.Tensor:
    """(B, V) float32 scores whose argmax is the sampled token: the
    filtered logits plus the Gumbel noise keyed by ``fold_in(fold_in(
    PRNGKey(seed), rid), idx)`` per row."""
    lg = filtered_logits(logits, temperature=temperature, top_k=top_k,
                         top_p=top_p)
    keys = fold_in(fold_in(prng_key(seed, lg.device), rids), idxs)
    return gumbel_from_bits(random_bits(keys, lg.shape[-1])) + lg


def sample_tokens(logits: torch.Tensor, rids: torch.Tensor,
                  idxs: torch.Tensor, *, temperature: float = 1.0,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None,
                  seed: int = 0) -> torch.Tensor:
    """Draw one token per row. logits: (B, V), any float dtype; rids,
    idxs: (B,) integer (request id, 0-based output token index). Returns
    (B,) int32: the first index of each row's largest perturbed score,
    as ``jax.random.categorical``."""
    return torch.argmax(
        perturbed_scores(logits, rids, idxs, temperature=temperature,
                         top_k=top_k, top_p=top_p, seed=seed),
        dim=-1).to(torch.int32)


class TokenSampler:
    """A SamplingSpec bound to callable form for the engines."""

    def __init__(self, spec=None):
        self.method = getattr(spec, "method", "greedy")
        self.temperature = float(getattr(spec, "temperature", 1.0))
        self.top_k = getattr(spec, "top_k", None)
        self.top_p = getattr(spec, "top_p", None)
        self.seed = int(getattr(spec, "seed", 0))

    @property
    def greedy(self) -> bool:
        return self.method == "greedy"

    def sample(self, logits: torch.Tensor, rids: torch.Tensor,
               idxs: torch.Tensor) -> torch.Tensor:
        """One token per row: (B, V) logits, (B,) request ids and 0-based
        output token indices -> (B,) int32. Greedy ignores the keys and
        takes the argmax (first index on ties, as ``jnp.argmax``)."""
        if self.greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return sample_tokens(logits, rids, idxs,
                             temperature=self.temperature,
                             top_k=self.top_k, top_p=self.top_p,
                             seed=self.seed)
