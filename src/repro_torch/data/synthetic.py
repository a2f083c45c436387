"""Synthetic datasets (numpy copies of :mod:`repro.data.synthetic`, kept in
the port so it imports nothing of ``repro``: the same seed gives the same
images and tokens).

``make_classification_dataset`` builds a CIFAR-like image task: each class
is a smooth random template plus per-sample spatial jitter and noise.
It builds in float64 before the final cast, so 50,000 images of 32x32
hold ~1.2 GB a buffer (~4 GB at the peak) on the host while it runs.
``make_lm_dataset`` builds client-conditioned token streams.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_classification_dataset(num_samples: int, num_classes: int = 10,
                                image_size: int = 32, seed: int = 0,
                                template_seed: int = 1234
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (N, H, W, 3) float32 in [-1, 1], labels (N,) int64).

    ``template_seed`` fixes the class templates so different calls (train /
    test splits) share the same concepts; ``seed`` varies the samples.
    """
    rng = np.random.default_rng(seed)
    h = w = image_size
    # smooth class templates: low-frequency random fields
    freq = 4
    base = np.random.default_rng(template_seed).normal(
        size=(num_classes, freq, freq, 3)) * 1.5
    templates = np.stack([
        np.kron(base[c], np.ones((h // freq, w // freq, 1)))
        for c in range(num_classes)])
    labels = rng.integers(0, num_classes, size=num_samples)
    images = templates[labels]
    # per-sample jitter: random shifts + noise
    shifts = rng.integers(-3, 4, size=(num_samples, 2))
    out = np.empty_like(images)
    for i in range(num_samples):
        out[i] = np.roll(images[i], tuple(shifts[i]), axis=(0, 1))
    out += rng.normal(scale=1.4, size=out.shape)
    out = np.tanh(out).astype(np.float32)
    return out, labels.astype(np.int64)


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
