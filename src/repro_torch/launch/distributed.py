"""The PSL training engine of the port (mirrors
:mod:`repro.launch.distributed`): the fused PSL step on one card, or on a
(data × model) mesh of ranks over ``torch.distributed``.

``repro`` lowers the fused step of ``repro.core.psl`` onto a device mesh
from one controller. The port runs one process a rank (``python -m
torch.distributed.run``), each holding its part of the state, and makes
the collectives explicit (:class:`repro_torch.launch.mesh.MeshComm`). On
a mesh both lowerings share the sum form of :mod:`repro_torch.core.psl`:

* every rank sums the slot weights of its rows of the global batch, and an
  all-reduce over the batch axes gives the weight mass ``w_total``;
* ``accumulate_sum_grads`` runs on the rank's rows, giving fp32 gradient
  and metric sums; the metric sums are all-reduced over the batch axes
  and the gradient sums reduced there, then normalized once by the mass.
  Because padding slots weigh 0, where slots land on ranks never changes
  the step.

The lowerings differ in what a rank stores:

* ``lowering="gspmd"``: each rank stores only its block of each
  parameter and moment, as ``repro_torch.sharding.train_state_shardings``
  lays it out for the profile (tp / fsdp / ddp); client leaves stay
  replicated over the data axes. Before the forward a rank all-gathers
  the whole client and server trees; after the backward it
  reduce-scatters (or all-reduces and slices) the fp32 gradient sums over
  the batch axes into its blocks, and AdamW or SGD updates the blocks
  (``repro_torch.optim`` is leaf by leaf). The gathered copy and the full
  gradients are freed before the next step. The batch is split over the
  profile's batch axes (``sharding.batch_axes``): under fsdp and ddp over
  all axes, so every mesh shape computes without duplicate work.
* ``lowering="shard_map"`` (explicit data parallelism, ``repro``'s
  ``shard_map`` program): parameters and moments are replicated, the
  batch is split over ``data``, and the gradient sums are all-reduced.

``tp`` on a mesh with ``model > 1`` (gspmd) is Megatron tensor-parallel
compute, as GSPMD derives it in ``repro`` (:mod:`repro_torch.launch.
tensor_parallel`): a rank all-gathers each leaf over the data axes only
and keeps its ``model`` block; its q and kv heads go through B1 and
B1-bwd, the MLP's columns through its products, its Mamba channels (or
Mamba-2 heads) through B4 or the per-head B4 and their backwards, its
MoE experts on the assignments routed to them, row-parallel products
and the experts' combine are all-reduced over ``model``, and a split
vocab runs a vocab-parallel embedding and B5 with a cross-rank
logsumexp. The gradient sums of those blocks are reduce-scattered over
the batch axes only; a leaf computed whole keeps the whole path (its
sums reduced over the batch axes, and over ``model`` too where each
rank's is partial: the mixer's in_proj, Mamba-2's conv and per-head
leaves). Every family but the CNN computes in parallel (the audio
family's encoder, decoder and cross-attention alike); the CNN runs
replicated over ``model``. ``repro``'s ``shard_map`` program replicates
every leaf whatever the profile, so ``tp`` with ``shard_map`` runs as
explicit data parallelism there too. ``tp`` on D × 1 keeps FSDP over
``data``. A batch whose leading axis does not divide over the batch axes
is replicated: every rank then holds it whole and nothing is summed
across ranks, so it is not counted once a rank.

MoE dispatch. ``repro``'s gspmd program runs ``moe_apply`` once over the
global microbatch: capacity from the global token count, positions
counted over every row, the aux loss ``E · Σ f_e p_e`` over the global
means. On ``gspmd`` with the batch split, the engine sets
``layers.BatchShards`` for the step, so a rank's MoE layers dispatch its
rows as that one dispatch would (each layer all-gathers the ranks'
per-expert counts over the batch axes) and each rank's aux term is its
share of the global aux; the shares enter with weight ``w_total`` and
the metric reports their sum, ``aux_sum / M``. A microbatch there is
each rank's m-th slice of its rows, so with M > 1 the global microbatch
is the union of the ranks' m-th slices, not ``repro``'s m-th contiguous
block (``ROADMAP.md`` C). ``shard_map`` dispatches shard by shard, as
``repro``'s shard_map program does: a rank's aux term is computed on its
own rows and enters with weight ``w_total / shards``, so the summed
gradient is that of the mean over the shards, the metric
``aux_sum / (shards · M)`` reports (``repro``'s shard_map program weights
each shard's aux term by ``w_total``). Dense, audio and CNN models carry
no aux loss.

On one card (a mesh of one rank: ``mesh`` None in a single process,
"1x1", or "auto" with one rank) the engine runs the fused step of
:mod:`repro_torch.core.psl` as it always has, for either lowering, with
no process group. The straggler helpers (``assign_clients_to_shards``,
``shard_arrivals``, ``step_timing``) are numpy and are ``repro``'s,
copied.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import sharding as shard_lib
from repro_torch.core.psl import (accumulate_sum_grads, fused_grads,
                                  make_train_step, requires_grad_)
from repro_torch.launch import tensor_parallel as tp_lib
from repro_torch.launch.mesh import (AXES, MeshComm, make_training_mesh,
                                     mesh_sizes, parse_mesh_spec,
                                     rank_device)
from repro_torch.models.layers import (BatchShards, set_batch_shards,
                                       tree_leaves, tree_map, tree_unflatten)
from repro_torch.optim import Optimizer, TrainState

_SUMS = ("loss_sum", "acc_sum", "aux_sum", "tokens")
_DTYPES = {"tokens": torch.int64, "labels": torch.int32,
           "weights": torch.float32, "images": torch.float32}


def data_shard_count(mesh, profile: str = "tp") -> int:
    """Number of batch shards the mesh/profile splits the global batch
    into."""
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in shard_lib.batch_axes(mesh, profile))


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


class ShardedBatch(dict):
    """A rank's rows of a global batch (``put_batch``); ``shards`` is the
    number of distinct row blocks across ranks (1 when every rank holds
    the whole batch) and ``index`` the rank's block."""
    shards: int = 1
    index: int = 0


def _batch_digest(host: Dict[str, Any]) -> int:
    """A signed 64-bit digest of a host batch (keys, dtypes, shapes and
    bytes)."""
    h = hashlib.blake2b(digest_size=8)
    for key in sorted(host):
        a = np.ascontiguousarray(host[key])
        h.update(f"{key}:{a.dtype}:{a.shape}".encode())
        h.update(a.tobytes())
    return int.from_bytes(h.digest(), "little", signed=True)


class ShardedPSLEngine:
    """The fused PSL step on one card or on a (data × model) mesh of
    ranks, behind ``repro``'s engine API::

        engine = ShardedPSLEngine(model, optimizer, mesh="2x2",
                                  profile="fsdp")
        state = engine.init_state(seed)
        state, metrics = engine.step(state, engine.put_batch(host_batch))

    ``mesh`` is a DeviceMesh (``repro_torch.launch.mesh``), a spec
    ("DxM", "auto") or None ("auto"). ``step`` updates the state's
    parameters in place and returns its metrics as Python floats, equal
    on every rank: reading them waits for the card. With
    ``time_collectives`` the mesh's collectives are timed
    (``comm.stats``), which synchronizes around each of them.
    """

    def __init__(self, model, optimizer: Optimizer, mesh=None,
                 profile: str = "tp", lowering: str = "gspmd",
                 microbatches: int = 1, device="cuda",
                 time_collectives: bool = False):
        if lowering not in ("gspmd", "shard_map"):
            raise ValueError(f"unknown lowering {lowering!r}")
        if profile not in ("tp", "fsdp", "ddp"):
            raise ValueError(f"unknown sharding profile {profile!r}")
        mesh = "auto" if mesh is None else mesh
        shape = (parse_mesh_spec(mesh) if isinstance(mesh, str)
                 else tuple(mesh_sizes(mesh)[a] for a in AXES))
        self.model = model
        self.optimizer = optimizer
        self.profile = profile
        self.lowering = lowering
        self.microbatches = microbatches
        self.report = shard_lib.ShardingReport()
        if math.prod(shape) == 1:
            self.mesh = self.comm = None
            self.device = torch.device(device)
            self.num_shards = 1
            self._step = make_train_step(model, optimizer,
                                         microbatches=microbatches)
            return
        self.mesh = (make_training_mesh(mesh, device)
                     if isinstance(mesh, str) else mesh)
        self.device = rank_device(device)
        self.comm = MeshComm(self.mesh, timed=time_collectives)
        self.num_shards = data_shard_count(self.mesh, profile)
        layouts = shard_lib.train_state_shardings(
            model, optimizer, self.mesh,
            self.report if lowering == "gspmd" else None,
            profile=profile).params
        if lowering == "shard_map":
            layouts = tree_map(lambda _: shard_lib.replicated(), layouts)
            self._batch_axes: Tuple[str, ...] = ("data",)
        else:
            self._batch_axes = shard_lib.batch_axes(self.mesh, profile)
        self.param_layouts = layouts
        self._shapes = [s.shape for s in tree_leaves(model.param_specs())]
        self.tp = None
        modes = ["whole"] * len(self._shapes)
        if profile == "tp" and any(
                "model" in shard_lib.layout_axes(lay)
                and self.comm.sizes["model"] > 1
                for lay in tree_leaves(layouts)):
            self.tp = tp_lib.TensorParallel(model, layouts, self.comm)
            modes = self.tp.modes
        # how each leaf is gathered for the compute, and over which extra
        # axes its gradient sums are reduced (see tensor_parallel)
        sizes = self.comm.sizes
        self._modes = modes
        self._compute_layouts = [
            tp_lib.drop_model(lay) if mode == "local" else lay
            for lay, mode in zip(tree_leaves(layouts), modes)]
        self._compute_shapes = [
            tuple(n // sizes["model"]
                  if mode == "local" and d < len(lay) and "model" in lay[d]
                  else n for d, n in enumerate(shape))
            for shape, lay, mode in zip(self._shapes, tree_leaves(layouts),
                                        modes)]

    # ------------------------------------------------------------- state
    def init_state(self, seed: int = 0) -> TrainState:
        """Every rank draws the whole tree from ``seed`` on its device (the
        one-card init, bit for bit) and keeps its blocks; the optimizer
        state is made for those blocks."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = self.model.init(gen)
        params = (requires_grad_(params) if self.mesh is None
                  else self.shard_tree(params))
        return TrainState(params=params,
                          opt_state=self.optimizer.init(params), step=0)

    def shard_tree(self, tree):
        """A whole parameter-shaped tree → this rank's blocks of it."""
        if self.mesh is None:
            return tree
        comm = self.comm
        return tree_map(
            lambda x, lay: (shard_lib.local_slice(
                x, lay, comm.sizes, comm.coord).clone()
                if shard_lib.layout_axes(lay) else x),
            tree, self.param_layouts)

    def gather_params(self, params):
        """The whole parameter tree from every rank's blocks (an
        all-gather a sharded leaf; the stored tensor of a replicated
        one)."""
        if self.mesh is None:
            return params
        leaves = [self.comm.all_gather_leaf(p, lay, shape)
                  for p, lay, shape in zip(
                      tree_leaves(params), tree_leaves(self.param_layouts),
                      self._shapes)]
        return tree_unflatten(params, leaves)

    # ------------------------------------------------------------- batch
    def put_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Host numpy batch → this rank's rows on its device (tokens int64
        for the embedding gather, labels int32, weights and images fp32).

        On a mesh the rank keeps its contiguous block of the leading axis,
        as ``PartitionSpec`` splits it over the batch axes, after the slot
        layout of ``GlobalBatchIterator(num_shards=)``; a batch that does
        not divide is kept whole (noted in ``report``). The ranks first
        all-gather a 64-bit digest of the host batch and raise if they
        disagree: ranks whose planners drew different plans fail here."""
        if self.mesh is None:
            return {k: torch.as_tensor(np.asarray(v)).to(
                        device=self.device, dtype=_DTYPES.get(k),
                        non_blocking=True)
                    for k, v in batch.items()}
        host = {k: np.asarray(v) for k, v in batch.items()}
        digests = [row[0] for row in
                   self.comm.all_gather_ints([_batch_digest(host)])]
        if len(set(digests)) > 1:
            raise ValueError(
                f"the ranks were given different host batches (digests "
                f"{digests}); every rank must draw the same plan and "
                f"batches")
        b = next(iter(host.values())).shape[0]
        shard_lib.batch_shardings(host, self.mesh, b, self.report,
                                  profile=self.profile)
        sizes, coord = self.comm.sizes, self.comm.coord
        total = math.prod(sizes[a] for a in self._batch_axes)
        split = total > 1 and all(x.ndim and x.shape[0] % total == 0
                                  for x in host.values())
        rows, index = slice(None), 0
        if split:
            for a in self._batch_axes:
                index = index * sizes[a] + coord[a]
            rows = slice(index * b // total, (index + 1) * b // total)
        out = ShardedBatch({k: torch.as_tensor(v[rows]).to(
            device=self.device, dtype=_DTYPES.get(k), non_blocking=True)
            for k, v in host.items()})
        out.shards, out.index = (total, index) if split else (1, 0)
        return out

    # -------------------------------------------------------------- step
    def _compute_params(self, params):
        """The tree the rank computes with: each leaf all-gathered whole,
        or, under tensor parallelism, a "local" leaf over the data axes
        only (its ``model`` block). A leaf with nothing to gather is an
        alias of the stored block (detached: marking it differentiable
        leaves the stored block as it is)."""
        return tree_unflatten(params, [
            self.comm.all_gather_leaf(p.detach(), lay, shape)
            for p, lay, shape in zip(tree_leaves(params),
                                     self._compute_layouts,
                                     self._compute_shapes)])

    def _global_dispatch(self, batch: ShardedBatch) -> bool:
        """Whether the step's MoE layers dispatch over every shard's rows
        (gspmd with the batch split; the module's docstring says why)."""
        return self.lowering == "gspmd" and batch.shards > 1

    def _sum_grads(self, params, batch: ShardedBatch):
        """Gather the tree, and sum the rank's gradients and metrics:
        (fp32 gradient sums, metric sums all-reduced, reduce axes)."""
        if not isinstance(batch, ShardedBatch):
            raise TypeError("on a mesh, pass batches through put_batch")
        axes = self._batch_axes if batch.shards > 1 else ()
        full = requires_grad_(self._compute_params(params))
        w_total = self.comm.all_reduce(batch["weights"].float().sum(), axes)
        shards = None
        if self._global_dispatch(batch):
            shards = BatchShards(batch.shards, batch.index,
                                 lambda t: self.comm.all_gather(t, axes))
        prev = tp_lib.set_tensor_parallel(self.tp)
        prev_shards = set_batch_shards(shards)
        try:
            g_sum, m_sum = accumulate_sum_grads(
                self.model, full, batch, self.microbatches,
                w_total if shards else w_total / batch.shards)
        finally:
            tp_lib.set_tensor_parallel(prev)
            set_batch_shards(prev_shards)
        del full
        sums = self.comm.all_reduce(torch.stack([m_sum[k] for k in _SUMS]),
                                    axes)
        return g_sum, sums, axes

    def _grad_axes(self, i: int, axes):
        """The axes leaf ``i``'s gradient sums are reduced over: the batch
        axes, and ``model`` where each rank's sum is partial."""
        if self._modes[i] == "partial":
            return tuple(axes) + ("model",)
        return axes

    def _metrics(self, sums, batch: ShardedBatch
                 ) -> Dict[str, torch.Tensor]:
        denom = torch.clamp(sums[3], min=1e-6)
        shards = 1 if self._global_dispatch(batch) else batch.shards
        return {"loss": sums[0] / denom, "accuracy": sums[1] / denom,
                "aux_loss": sums[2] / (shards * self.microbatches),
                "tokens": sums[3]}

    def step(self, state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, float]]:
        if self.mesh is None:
            state, metrics = self._step(state, batch)
            return state, {k: float(v) for k, v in metrics.items()}
        g_sum, sums, axes = self._sum_grads(state.params, batch)
        denom = torch.clamp(sums[3], min=1e-6)
        leaves = tree_leaves(g_sum)
        del g_sum
        layouts = tree_leaves(self.param_layouts)
        local, sq = [], torch.zeros((), device=self.device)
        for i, lay in enumerate(layouts):
            g = self.comm.reduce_scatter_leaf(
                leaves[i], self._compute_layouts[i], self._grad_axes(i, axes))
            leaves[i] = None                 # free the full sum
            local.append(g.div_(denom))
            if shard_lib.is_owner(lay, self.comm.coord):
                sq = sq + torch.sum(g.float() ** 2)
        grads = tree_unflatten(state.params, local)
        metrics = self._metrics(sums, batch)
        metrics["grad_norm"] = torch.sqrt(self.comm.all_reduce(sq, AXES))
        opt_state = self.optimizer.apply_updates(state.params, grads,
                                                 state.opt_state)
        return (TrainState(params=state.params, opt_state=opt_state,
                           step=state.step + 1),
                {k: float(v) for k, v in metrics.items()})

    # -------------------------------------------------------- diagnostics
    def grads(self, state: TrainState, batch: Dict[str, Any]):
        """Normalized full-batch gradient (fp32) of this engine's step,
        whole on every rank — what the equivalence tests compare."""
        if self.mesh is None:
            return fused_grads(self.model, state.params, batch,
                               self.microbatches)[0]
        g_sum, sums, axes = self._sum_grads(state.params, batch)
        denom = torch.clamp(sums[3], min=1e-6)
        out = []
        for i, (g, lay, shape) in enumerate(zip(
                tree_leaves(g_sum), tree_leaves(self.param_layouts),
                self._shapes)):
            g = self.comm.all_reduce(g, self._grad_axes(i, axes)).div_(denom)
            if self._modes[i] == "local":
                g = self.comm.all_gather_leaf(g, tp_lib.model_only(lay),
                                              shape)
            out.append(g)
        return tree_unflatten(g_sum, out)
