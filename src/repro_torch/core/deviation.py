"""Batch-deviation bounds the live GPSL monitor needs (numpy copy of
``serfling_bound`` and ``serfling_epsilon`` of :mod:`repro.core.deviation`;
the Lemma 1–2 terms and the Monte-Carlo plan deviation of Figs. 6–7 wait
for the benchmark twins, ROADMAP A.11)."""
from __future__ import annotations

import numpy as np


def serfling_bound(batch_size: int, total: int, eps: float) -> float:
    """Serfling (1974) tail bound for sampling without replacement.

    For B draws uniformly without replacement from a population of D items,
    of which a fraction β_0m belong to class m,

        P(|Y_m/B − β_0m| ≥ ε) ≤ 2·exp(−2Bε² / (1 − (B−1)/D)).

    This is the paper's distributional-equivalence guarantee for a GPSL
    global batch: its class histogram concentrates around β_0 exactly as a
    centralized uniform without-replacement batch does (and *tighter* than
    the with-replacement Hoeffding bound by the finite-population factor).
    """
    b = int(batch_size)
    d = max(int(total), 1)
    f = max(1.0 - (b - 1.0) / d, 1e-12)
    return float(2.0 * np.exp(-2.0 * b * eps * eps / f))


def serfling_epsilon(batch_size: int, total: int, delta: float) -> float:
    """Invert :func:`serfling_bound`: the ε with tail mass exactly δ."""
    b = int(batch_size)
    d = max(int(total), 1)
    f = max(1.0 - (b - 1.0) / d, 1e-12)
    return float(np.sqrt(f * np.log(2.0 / delta) / (2.0 * b)))
