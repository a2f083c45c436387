"""The PSL training protocol as PyTorch step functions (port of
:mod:`repro.core.psl`).

Two equivalent realizations of one optimization step (Sec. III, steps 1–6):

  * ``make_train_step``  — the *fused* step: one backward through the whole
    split model with per-slot weights encoding the server-side gradient
    aggregation. The production path.
  * ``decomposed_grads`` — the *literal* protocol: client FP → cut-activation
    transfer (a detached leaf that requires grad) → server FP/BP →
    cut-gradient broadcast → client BP. The tests prove the fused step
    computes exactly the paper's update, and ``cut_transfer_bytes`` counts
    what crosses the cut.

Slot-weight semantics (how the global batch encodes the paper's step 5):
  aggregation="global_mean"     w_i = 1                (mean over the B slots)
  aggregation="client_weighted" w_i = (D_k/D_0)·B/B_k^t  for slot i of client
    k — reproducing  ḡ = Σ_k (D_k/D_0) ḡ_k. The numpy weight functions are
    ``repro``'s, copied, so the weights are bit-identical.

Parameters are nested dicts of tensors; gradients come from
``torch.autograd.grad`` (no ``.grad`` fields), in the parameters' dtype
for the single-pass step and in fp32 for microbatch accumulation — as
``jax.value_and_grad`` and ``repro``'s accumulation return them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.models.layers import tree_leaves, tree_unflatten
from repro_torch.optim import Optimizer, TrainState


def slot_weights(client_ids: np.ndarray, local_batch_sizes: np.ndarray,
                 dataset_sizes: np.ndarray,
                 aggregation: str = "global_mean") -> np.ndarray:
    """Per-slot loss weights for one global batch.

    client_ids: (B,) source client of each slot (-1 = padding).
    local_batch_sizes: (K,) this step's B_k^t.
    """
    valid = client_ids >= 0
    if aggregation == "global_mean":
        return valid.astype(np.float32)
    if aggregation != "client_weighted":
        raise ValueError(aggregation)
    d = dataset_sizes.astype(np.float64)
    pi = d / d.sum()
    bk = np.maximum(local_batch_sizes, 1)
    b = max(int(valid.sum()), 1)
    w = np.where(valid, pi[np.maximum(client_ids, 0)]
                 / bk[np.maximum(client_ids, 0)] * b, 0.0)
    return w.astype(np.float32)


def slot_weights_segments(client_ids: np.ndarray, slot_counts: np.ndarray,
                          dataset_sizes: np.ndarray,
                          aggregation: str = "global_mean") -> np.ndarray:
    """Segment-streamed twin of :func:`slot_weights`: takes the owning
    client's B_k^t per slot, so no O(K) per-step state is built; same
    operation order, hence bit-identical weights.

    client_ids: (B,) source client of each slot (-1 = padding).
    slot_counts: (B,) B_k^t of each slot's owner (any value ≥ 1 on padding).
    """
    valid = client_ids >= 0
    if aggregation == "global_mean":
        return valid.astype(np.float32)
    if aggregation != "client_weighted":
        raise ValueError(aggregation)
    d = dataset_sizes.astype(np.float64)
    total = d.sum()
    bk = np.maximum(slot_counts, 1)
    b = max(int(valid.sum()), 1)
    w = np.where(valid, d[np.maximum(client_ids, 0)] / total / bk * b, 0.0)
    return w.astype(np.float32)


# ---------------------------------------------------------------------------
# Gradients of a params tree
# ---------------------------------------------------------------------------

def requires_grad_(params) -> Any:
    """Mark every leaf of a params tree as a differentiable leaf."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def value_and_grad(fn: Callable, params, *args):
    """``(fn(params, *args), grads)`` where ``fn`` returns ``(scalar,
    aux)``; grads are structured like params. The aux values come back
    detached."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        total, aux = fn(params, *args)
        grads = torch.autograd.grad(total, leaves)
    aux = {k: v.detach() for k, v in aux.items()}
    return (total.detach(), aux), tree_unflatten(params, grads)


def grad_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.float() ** 2)
                          for g in tree_leaves(grads)))


def _split(batch: Dict[str, Any], m: int) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = [dict() for _ in range(m)]
    for key, x in batch.items():
        if x.shape[0] % m:
            raise ValueError(
                f"global batch axis {x.shape[0]} not divisible into "
                f"{m} microbatches")
        for i, part in enumerate(x.chunk(m, dim=0)):
            out[i][key] = part
    return out


def accumulate_sum_grads(model, params, batch, num_microbatches: int,
                         w_total):
    """fp32 gradient of the *weighted-sum* objective, microbatch by
    microbatch: Σ_m ∇[loss_m · w_m + aux_m · w_total / M], where w_m is
    microbatch m's weight mass (``metrics["tokens"]``). Dividing by
    w_total reproduces the fused single-pass gradient up to fp
    reassociation (exact whenever aux_loss ≡ 0, as for the dense LM).

    Returns ``(grad_sums, metric_sums)`` with metric_sums {loss_sum,
    acc_sum, aux_sum, tokens}, as ``repro.core.psl.accumulate_sum_grads``.
    """
    m = num_microbatches

    def scaled_loss(p, mb):
        _, metrics = model.loss_fn(p, mb)
        w_m = metrics["tokens"]
        return (metrics["loss"] * w_m + metrics["aux_loss"] * (w_total / m),
                metrics)

    g_acc = None
    zero = torch.zeros((), dtype=torch.float32,
                       device=tree_leaves(params)[0].device)
    sums = {k: zero for k in ("loss_sum", "acc_sum", "aux_sum", "tokens")}
    for mb in _split(batch, m):
        (_, metrics), g = value_and_grad(scaled_loss, params, mb)
        g32 = [x.float() for x in tree_leaves(g)]
        g_acc = g32 if g_acc is None else [a + b for a, b in zip(g_acc, g32)]
        w_m = metrics["tokens"]
        sums = {"loss_sum": sums["loss_sum"] + metrics["loss"] * w_m,
                "acc_sum": sums["acc_sum"] + metrics["accuracy"] * w_m,
                "aux_sum": sums["aux_sum"] + metrics["aux_loss"],
                "tokens": sums["tokens"] + w_m}
    return tree_unflatten(params, g_acc), sums


def normalize_sum_grads(grad_sums, metric_sums, num_microbatches: int):
    """Sum-form grads/metrics → the fused step's (grads, metrics)."""
    denom = torch.clamp(metric_sums["tokens"], min=1e-6)
    grads = tree_unflatten(grad_sums,
                           [g / denom for g in tree_leaves(grad_sums)])
    metrics = {"loss": metric_sums["loss_sum"] / denom,
               "accuracy": metric_sums["acc_sum"] / denom,
               "aux_loss": metric_sums["aux_sum"] / num_microbatches,
               "tokens": metric_sums["tokens"]}
    return grads, metrics


def fused_grads(model, params, batch, microbatches: int = 1):
    """Normalized full-batch gradient via microbatch accumulation (fp32);
    with ``microbatches=1`` the fused backward in sum-then-normalize
    form."""
    w_total = batch["weights"].float().sum()
    g_sum, m_sum = accumulate_sum_grads(model, params, batch, microbatches,
                                        w_total)
    return normalize_sum_grads(g_sum, m_sum, microbatches)


def make_train_step(model, optimizer: Optimizer,
                    microbatches: int = 1) -> Callable:
    """Fused PSL optimization step: (state, batch) -> (state, metrics).

    The parameters are updated in place, leaf by leaf
    (``optimizer.apply_updates``), and the returned state holds the same tensors.
    ``microbatches > 1`` accumulates fp32 gradients over that many slices
    of the global batch; the update equals the single-pass step within fp
    tolerance whenever aux_loss is zero.
    """

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if microbatches > 1:
            grads, metrics = fused_grads(model, state.params, batch,
                                         microbatches)
        else:
            (_, metrics), grads = value_and_grad(model.loss_fn,
                                                 state.params, batch)
        metrics = dict(metrics)
        metrics["grad_norm"] = grad_norm(grads)
        opt_state = optimizer.apply_updates(state.params, grads, state.opt_state)
        return TrainState(params=state.params, opt_state=opt_state,
                          step=state.step + 1), metrics

    return step


def decomposed_grads(model, params, batch):
    """The six-substep PSL protocol, made explicit (Sec. III).

    Returns (loss, grads, cut_activations) with grads structured like
    params. Substeps:
      1/2. client FP → cut activations (the client→server transfer: a
           detached tensor that requires grad on the server side);
      3.   server FP + BP — grads w.r.t. server params AND the cut;
      4.   cut gradient broadcast → client BP (backward through the
           client segment from the cut gradient);
      5/6. the weighted averaging over clients is encoded in the slot
           weights already present in ``batch`` (see slot_weights).
    """
    client_leaves = tree_leaves(params["client"])
    server_leaves = tree_leaves(params["server"])
    with torch.enable_grad():
        cut = model.client_forward(params, batch)
        cut_server = cut.detach().requires_grad_(True)
        loss = model.server_loss(params["server"], cut_server, batch)
        *g_server, g_cut = torch.autograd.grad(
            loss, server_leaves + [cut_server])
        g_client = torch.autograd.grad(cut, client_leaves, grad_outputs=g_cut)
    grads = {"client": tree_unflatten(params["client"], g_client),
             "server": tree_unflatten(params["server"], g_server)}
    return loss.detach(), grads, cut.detach()


def cut_transfer_bytes(model, batch: Dict[str, Any]) -> Dict[str, int]:
    """Bytes crossing the client↔server boundary per step (both
    directions: activations up, cut gradients down): the client forward's
    output in the model dtype — (B, S, d_model) for a decoder LM (a VLM's
    patches ahead of its S tokens), the encoder states (B, T_enc,
    d_model) for the audio family."""
    b, s = batch["tokens"].shape[:2]
    if "frames" in batch:
        s = batch["frames"].shape[1]
    elif "patches" in batch:
        s += batch["patches"].shape[1]
    itemsize = torch.empty((), dtype=model.cfg.torch_dtype).element_size()
    n = int(b) * int(s) * model.cfg.d_model * itemsize
    return {"activations": n, "gradients": n, "total": 2 * n}
