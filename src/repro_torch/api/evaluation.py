"""Shared batch/eval helpers of the port (port of :mod:`repro.api.
evaluation`).

One definition of the host->device batch adapter (``batch_from``) and the
held-out accuracy evaluation (``evaluate``), shared by the protocol
strategies and the launch CLI.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.layers import tree_leaves


def batch_from(features, labels, weights=None,
               device="cpu") -> Dict[str, Any]:
    """Batch for the fused step from host arrays (CNN workloads), built on
    ``device``: images float32 NHWC, labels int64 (the loss gathers with
    them), weights float32 (ones when not given)."""
    w = np.ones(len(labels), np.float32) if weights is None else weights
    return {"labels": torch.as_tensor(np.asarray(labels, np.int64),
                                      device=device),
            "weights": torch.as_tensor(np.asarray(w, np.float32),
                                       device=device),
            "images": torch.as_tensor(np.asarray(features, np.float32),
                                      device=device)}


@torch.no_grad()
def evaluate(model, params, features: np.ndarray, labels: np.ndarray,
             batch_size: int = 512) -> float:
    """Top-1 accuracy of ``model.predict(params, .)`` over a held-out set,
    in batches of ``batch_size`` on the params' device."""
    device = tree_leaves(params)[0].device
    correct = 0
    for i in range(0, len(features), batch_size):
        images = torch.as_tensor(
            np.asarray(features[i:i + batch_size], np.float32),
            device=device)
        pred = model.predict(params, images).argmax(-1).cpu().numpy()
        correct += int((pred == labels[i:i + batch_size]).sum())
    return correct / len(features)
