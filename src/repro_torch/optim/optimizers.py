"""SGD(+momentum, weight decay) and AdamW over nested-dict parameter
trees (port of :mod:`repro.optim.optimizers`).

The arithmetic is ``repro``'s: moments in fp32 whatever the parameter
dtype, the update added in fp32 and cast back to the parameter dtype
(``repro``'s ``apply_updates``), AdamW's bias corrections
``1 - b ** count`` computed in fp32. Where ``repro`` builds an update tree
(``update``) and adds it (``apply_updates``), an :class:`Optimizer` here
does both in place: ``apply_updates(params, grads, state) -> state`` walks
the tree leaf by leaf and writes each parameter and its moments, so the
update's fp32 temporaries are a few leaves large instead of whole trees
(2.5 GB each for full-width granite's largest stacked leaf, against
~10 GB for a tree, and the old and new moments never coexist).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    apply_updates: Callable[[Any, Any, Any], Any]   # (params, grads, state)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _make(init, leaf_update: Callable, slot_names, prepare: Callable):
    """An Optimizer from a per-leaf rule ``leaf_update(g, p, *slots,
    consts) -> (update_f32, *new_slots)``; ``prepare(state)`` returns
    (consts, the extra state entries of the new state)."""

    @torch.no_grad()
    def apply_updates(params, grads, state):
        consts, extra = prepare(state)
        gs, ps = tree_leaves(grads), tree_leaves(params)
        slots = [tree_leaves(state[n]) for n in slot_names]
        for i, (g, p) in enumerate(zip(gs, ps)):
            out = leaf_update(g, p, *(s[i] for s in slots), consts)
            p.copy_((p.float() + out[0]).to(p.dtype))
            for s, new in zip(slots, out[1:]):
                s[i].copy_(new)
            del out
        return {**state, **extra}

    return Optimizer(init=init, apply_updates=apply_updates)


def sgd(lr: float, momentum: float = 0.9, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"mu": _zeros_f32(params)}

    def leaf(g, p, mu, _):
        g = g.float()
        if weight_decay:
            g = g + weight_decay * p.float()
        mu_new = momentum * mu + g
        step_dir = (g + momentum * mu_new) if nesterov else mu_new
        return [-lr * step_dir, mu_new]

    return _make(init, leaf, ("mu",), lambda state: (None, {}))


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        device = tree_leaves(params)[0].device
        return {"m": _zeros_f32(params), "v": _zeros_f32(params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def prepare(state):
        count = state["count"] + 1
        cf = count.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=cf.device), cf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                          device=cf.device), cf)
        return (c1, c2), {"count": count}

    def leaf(g, p, m, v, consts):
        c1, c2 = consts
        g = g.float()
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        step = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        if weight_decay:
            step = step + weight_decay * p.float()
        return [-lr * step, m_new, v_new]

    return _make(init, leaf, ("m", "v"), prepare)
