"""Synthetic LM data (a numpy copy of :func:`repro.data.synthetic.
make_lm_dataset`, kept in the port so it imports nothing of ``repro``:
the same seed gives the same tokens)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_lm_dataset(num_sequences: int, seq_len: int, vocab_size: int,
                    num_styles: int = 8, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (tokens (N, S) int32, styles (N,) int64).

    Sequences follow  t_{i+1} = (a_s * t_i + c_s + noise) mod V  with
    style-specific (a_s, c_s): predictable structure an LM can learn, and a
    'style' label usable as a non-IID partitioning key.
    """
    rng = np.random.default_rng(seed)
    a = rng.integers(2, 8, size=num_styles)
    c = rng.integers(1, vocab_size - 1, size=num_styles)
    styles = rng.integers(0, num_styles, size=num_sequences)
    toks = np.empty((num_sequences, seq_len), dtype=np.int32)
    toks[:, 0] = rng.integers(0, vocab_size, size=num_sequences)
    noise = rng.integers(0, 2, size=(num_sequences, seq_len))
    for i in range(1, seq_len):
        toks[:, i] = (a[styles] * toks[:, i - 1] + c[styles]
                      + noise[:, i]) % vocab_size
    return toks, styles.astype(np.int64)
