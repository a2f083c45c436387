"""Plain PyTorch oracles for the ported kernels (transcribed from
:mod:`repro.kernels.ref`): the mathematically transparent O(naive)
implementations the kernel tests sweep against."""
from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """Naive softmax attention. q: (B, Hq, S, D); k, v: (B, Hkv, T, D)."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    rep = hq // hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(s, device=q.device)[:, None] + (t - s)  # align ends
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, page_table,
                        pos) -> torch.Tensor:
    """Naive paged decode attention: gather pages, then dense softmax.

    q: (B, Hq, D); k_pages, v_pages: (NP, P, Hkv, D);
    page_table: (B, M) int32; pos: (B,) int32. Key ``k`` of row ``b`` is
    attended iff ``k <= pos[b]``. Returns (B, Hq, D).
    """
    b, hq, d = q.shape
    psize, hkv = k_pages.shape[1], k_pages.shape[2]
    m = page_table.shape[1]
    rep = hq // hkv
    idx = page_table.long()
    k = k_pages[idx].reshape(b, m * psize, hkv, d)
    v = v_pages[idx].reshape(b, m * psize, hkv, d)
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    valid = (torch.arange(m * psize, device=q.device)[None, :]
             <= pos.long()[:, None])
    scores = torch.where(valid[:, None, :], scores,
                         torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def cross_entropy_ref(hidden, w_vocab, labels) -> torch.Tensor:
    """Per-token NLL with full logits. hidden: (T, d); w: (d, V); labels
    (T,). Returns nll (T,) fp32."""
    logits = hidden.float() @ w_vocab.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(1, labels.long()[:, None])[:, 0]
    return lse - tgt
