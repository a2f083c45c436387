"""The PSL training engine of the port (mirrors
:mod:`repro.launch.distributed`) on one CUDA card.

``repro`` lowers the fused PSL step onto a (data x model) device mesh;
the port runs the same step on exactly one card: ``num_shards == 1`` and
``lowering="gspmd"``, which here means the fused step of
:mod:`repro_torch.core.psl` on that card. Any other mesh, and the
explicit ``shard_map`` lowering, raise until the mesh engine is ported on
``torch.distributed`` (ROADMAP A.7). The straggler helpers
(``assign_clients_to_shards``, ``shard_arrivals``, ``step_timing``) are
numpy and are ``repro``'s, copied.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.psl import fused_grads, make_train_step, \
    requires_grad_
from repro_torch.optim import Optimizer, TrainState

_MESH_ITEM = ("the mesh engine is not ported to repro_torch yet "
              "(ROADMAP A.7, launch/distributed.py on torch.distributed); "
              "the port trains on exactly one card")


def assign_clients_to_shards(num_clients: int, num_shards: int) -> np.ndarray:
    """Static client → data-shard map (round-robin): client k's cut
    activations always land on shard k mod S."""
    return np.arange(num_clients, dtype=np.int64) % max(num_shards, 1)


def shard_arrivals(sizes_row: np.ndarray, delays: np.ndarray,
                   shard_of_client: np.ndarray,
                   num_shards: int) -> np.ndarray:
    """(S,) per-shard arrival times for one global batch.

    Shard s is ready when the slowest of *its* contributing clients
    (B_k^t > 0, shard_of_client[k] == s) has sent; shards with no
    contributing client are ready at 0.
    """
    sizes_row = np.asarray(sizes_row)
    contributing = sizes_row > 0
    eff = np.where(contributing, np.asarray(delays, np.float64), -np.inf)
    arrivals = np.full(num_shards, -np.inf)
    np.maximum.at(arrivals, shard_of_client, eff)
    return np.where(np.isfinite(arrivals), arrivals, 0.0)


@dataclasses.dataclass(frozen=True)
class StepTiming:
    """Simulated distributed step timing (straggler accounting)."""
    step_ms: float          # base + slowest shard's arrival
    shard_skew_ms: float    # max − min arrival over contributing shards


def step_timing(sizes_row: np.ndarray, delays: np.ndarray,
                shard_of_client: np.ndarray, num_shards: int,
                base_step_ms: float = 60.0) -> StepTiming:
    arr = shard_arrivals(sizes_row, delays, shard_of_client, num_shards)
    return StepTiming(step_ms=float(base_step_ms + arr.max()),
                      shard_skew_ms=float(arr.max() - arr.min()))


def _mesh_size(mesh: Optional[str]) -> int:
    """Devices a mesh spec names ("DxM" or "D"; None = one card here)."""
    if mesh is None:
        return 1
    try:
        dims = [int(x) for x in str(mesh).lower().split("x")]
    except ValueError:
        raise ValueError(f"bad mesh spec {mesh!r}; expected 'DxM'") from None
    return int(np.prod(dims))


class ShardedPSLEngine:
    """The fused PSL step on one card, behind ``repro``'s engine API::

        engine = ShardedPSLEngine(model, optimizer, device=dev)
        state = engine.init_state(seed)
        state, metrics = engine.step(state, engine.put_batch(host_batch))

    ``step`` updates the state's parameters in place and returns its
    metrics as Python floats: reading them waits for the card, so the
    loop's ``device_step`` span covers the step's device work.
    """

    def __init__(self, model, optimizer: Optimizer, mesh=None,
                 lowering: str = "gspmd", microbatches: int = 1,
                 device="cuda"):
        if lowering not in ("gspmd", "shard_map"):
            raise ValueError(f"unknown lowering {lowering!r}")
        if lowering == "shard_map":
            raise NotImplementedError(f"lowering 'shard_map': {_MESH_ITEM}")
        if _mesh_size(mesh) != 1:
            raise NotImplementedError(f"mesh {mesh!r}: {_MESH_ITEM}")
        self.model = model
        self.optimizer = optimizer
        self.lowering = lowering
        self.microbatches = microbatches
        self.device = torch.device(device)
        self.num_shards = 1
        self._step = make_train_step(model, optimizer,
                                     microbatches=microbatches)

    # ------------------------------------------------------------- state
    def init_state(self, seed: int = 0) -> TrainState:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = requires_grad_(self.model.init(gen))
        return TrainState(params=params,
                          opt_state=self.optimizer.init(params), step=0)

    # ------------------------------------------------------------- batch
    def put_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Host numpy batch → tensors on the card (tokens int64 for the
        embedding gather, labels int32, weights and images fp32)."""
        dtypes = {"tokens": torch.int64, "labels": torch.int32,
                  "weights": torch.float32, "images": torch.float32}
        return {k: torch.as_tensor(np.asarray(v)).to(
                    device=self.device, dtype=dtypes.get(k),
                    non_blocking=True)
                for k, v in batch.items()}

    # -------------------------------------------------------------- step
    def step(self, state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, float]]:
        state, metrics = self._step(state, batch)
        return state, {k: float(v) for k, v in metrics.items()}

    # -------------------------------------------------------- diagnostics
    def grads(self, state: TrainState, batch: Dict[str, Any]):
        """Normalized full-batch gradient (fp32) of this engine's step."""
        return fused_grads(self.model, state.params, batch,
                           self.microbatches)[0]
