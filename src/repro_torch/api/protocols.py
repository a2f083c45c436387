"""Built-in protocol strategies of the port: CL, SL, FL, SFL and PSL (port
of :mod:`repro.api.protocols`).

Each protocol from the paper's comparison (Sec. V) is a small strategy
object — plan, batch assembly, step, aggregation hook — registered under
its name and driven by the shared loop in :mod:`repro_torch.api.loop`.
The visiting orders and rng draws are ``repro``'s, so a spec gives the
same batches in both packages.

Every protocol builds its initial state in one function,
:func:`_fresh_state`. The port's optimizers update parameters in place
(``repro``'s functional update returns new ones), so wherever ``repro``
starts from a value it keeps using, the port starts from a clone: FL's
local models clone the round's global parameters, and each SFL client
clones the round's client segment. SFL's server segment is carried from
client to client on purpose; each client gets a fresh optimizer state.

PSL consults the ExecutionSpec: engine "fused" runs the fused step of
:mod:`repro_torch.core.psl` on the context's device; engine "sharded"
(and every LM workload, whatever ``execution.engine`` says, as in
``repro``) goes through the ShardedPSLEngine of
:mod:`repro_torch.launch.distributed` (one card, or the mesh of
``execution.mesh`` laid out by ``execution.sharding``) with per-step
straggler arrival accounting; evaluation runs on the gathered
parameters.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List

import numpy as np
import torch

from repro_torch.api.evaluation import batch_from
from repro_torch.api.registry import ProtocolStrategy, StepItem, \
    register_protocol
from repro_torch.core import sampling as sampling_lib
from repro_torch.core.psl import make_train_step, requires_grad_, \
    slot_weights_segments
from repro_torch.data.federated import GlobalBatchIterator
from repro_torch.models.layers import tree_map
from repro_torch.optim import TrainState


def _fresh_state(ctx) -> TrainState:
    """The initial TrainState of every protocol: the model's seeded init on
    the context's device and a fresh optimizer state."""
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.seed)
    params = requires_grad_(ctx.model.init(gen))
    return TrainState(params, ctx.optimizer.init(params), 0)


def _clone(params):
    """A fresh copy of a params tree, as differentiable leaves."""
    return tree_map(lambda p: p.detach().clone().requires_grad_(True),
                    params)


class _SingleStateStrategy(ProtocolStrategy):
    """Shared skeleton for protocols training one TrainState end to end."""

    def setup(self, ctx) -> Dict[str, Any]:
        return {"state": _fresh_state(ctx),
                "step": make_train_step(ctx.model, ctx.optimizer),
                "rng": np.random.default_rng(ctx.seed)}

    def step(self, ctx, pstate, item: StepItem):
        pstate["state"], metrics = pstate["step"](pstate["state"],
                                                  item.batch)
        return pstate, metrics

    def eval_params(self, ctx, pstate):
        return pstate["state"].params


@register_protocol("cl")
class CLStrategy(_SingleStateStrategy):
    """Central learning on the pooled dataset (upper baseline)."""

    def epoch_batches(self, ctx, pstate, plan, epoch) -> Iterator[StepItem]:
        features, labels = ctx.data.train
        bs = ctx.protocol.batch_size
        n = len(features)
        order = pstate["rng"].permutation(n)
        for i in range(0, n - bs + 1, bs):
            idx = order[i:i + bs]
            yield StepItem(batch_from(features[idx], labels[idx],
                                      device=ctx.device))


@register_protocol("sl")
class SLStrategy(_SingleStateStrategy):
    """Sequential split learning: clients take turns; weights hop along."""

    def epoch_batches(self, ctx, pstate, plan, epoch) -> Iterator[StepItem]:
        store = ctx.data.store
        rng = pstate["rng"]
        batch_size = ctx.protocol.batch_size
        for k in rng.permutation(store.num_clients):
            feats, labs = store.features[k], store.labels[k]
            order = rng.permutation(len(feats))
            bs = min(batch_size, len(feats))
            for i in range(0, len(feats) - bs + 1, bs):
                idx = order[i:i + bs]
                yield StepItem(batch_from(feats[idx], labs[idx],
                                          device=ctx.device), scope=k)


def _client_batches(ctx, rng, ki: int, passes: int) -> Iterator[StepItem]:
    """Client ``ki``'s local batches, ``passes`` shuffled passes over its
    shard (FL's local epochs; SFL takes one)."""
    feats, labs = ctx.data.store.features[ki], ctx.data.store.labels[ki]
    bs = min(ctx.protocol.batch_size, len(feats))
    for _ in range(passes):
        order = rng.permutation(len(feats))
        for i in range(0, len(feats) - bs + 1, bs):
            idx = order[i:i + bs]
            yield StepItem(batch_from(feats[idx], labs[idx],
                                      device=ctx.device), scope=ki)


def _tree_weighted_sum(trees, weights):
    """Σ_i w_i·tree_i in fp32, cast back to the leaves' dtype, as new
    differentiable leaves."""
    def leaf(*xs):
        total = sum(float(w) * x.detach().float()
                    for w, x in zip(weights, xs))
        return total.to(xs[0].dtype).requires_grad_(True)
    return tree_map(leaf, *trees)


@register_protocol("fl")
class FLStrategy(ProtocolStrategy):
    """FedAvg: local epochs on full model copies; size-weighted average."""

    def setup(self, ctx) -> Dict[str, Any]:
        k = ctx.data.store.num_clients
        local_epochs = ctx.protocol.local_epochs
        if local_epochs is None:
            local_epochs = max(1, int(np.log2(k)) - 1)   # paper App. A
        sizes = ctx.data.pop.dataset_sizes.astype(np.float64)
        return {"global_params": _fresh_state(ctx).params,
                "step": make_train_step(ctx.model, ctx.optimizer),
                "rng": np.random.default_rng(ctx.seed),
                "local_epochs": local_epochs,
                "weights": sizes / sizes.sum(),
                "locals": [], "st": None, "client": None}

    def _push_local(self, pstate):
        if pstate["st"] is not None:
            pstate["locals"].append(pstate["st"].params)

    def epoch_batches(self, ctx, pstate, plan, epoch) -> Iterator[StepItem]:
        for ki in range(ctx.data.store.num_clients):
            yield from _client_batches(ctx, pstate["rng"], ki,
                                       pstate["local_epochs"])

    def step(self, ctx, pstate, item: StepItem):
        if item.scope != pstate["client"]:
            self._push_local(pstate)
            local = _clone(pstate["global_params"])
            pstate["st"] = TrainState(local, ctx.optimizer.init(local), 0)
            pstate["client"] = item.scope
        pstate["st"], metrics = pstate["step"](pstate["st"], item.batch)
        return pstate, metrics

    def end_epoch(self, ctx, pstate, epoch):
        self._push_local(pstate)
        pstate["global_params"] = _tree_weighted_sum(pstate["locals"],
                                                     pstate["weights"])
        pstate.update(locals=[], st=None, client=None)
        return pstate

    def eval_params(self, ctx, pstate):
        return pstate["global_params"]


@register_protocol("sfl")
class SFLStrategy(ProtocolStrategy):
    """SplitFed-V1: shared server segment updated every batch; client
    segments FedAvg'd at the end of each round."""

    def setup(self, ctx) -> Dict[str, Any]:
        sizes = ctx.data.pop.dataset_sizes.astype(np.float64)
        return {"params": _fresh_state(ctx).params,
                "step": make_train_step(ctx.model, ctx.optimizer),
                "rng": np.random.default_rng(ctx.seed),
                "weights": sizes / sizes.sum(),
                "client_params": [], "server_side": None,
                "st": None, "client": None}

    def epoch_batches(self, ctx, pstate, plan, epoch) -> Iterator[StepItem]:
        for ki in range(ctx.data.store.num_clients):
            yield from _client_batches(ctx, pstate["rng"], ki, 1)

    def _push_local(self, pstate):
        if pstate["st"] is not None:
            pstate["client_params"].append(pstate["st"].params["client"])
            pstate["server_side"] = pstate["st"].params["server"]

    def step(self, ctx, pstate, item: StepItem):
        if item.scope != pstate["client"]:
            self._push_local(pstate)
            server = pstate["server_side"]
            if server is None:
                server = pstate["params"]["server"]
            seg = {"client": _clone(pstate["params"]["client"]),
                   "server": server}
            pstate["st"] = TrainState(seg, ctx.optimizer.init(seg), 0)
            pstate["client"] = item.scope
        pstate["st"], metrics = pstate["step"](pstate["st"], item.batch)
        return pstate, metrics

    def end_epoch(self, ctx, pstate, epoch):
        self._push_local(pstate)
        pstate["params"] = {
            "client": _tree_weighted_sum(pstate["client_params"],
                                         pstate["weights"]),
            "server": pstate["server_side"]}
        pstate.update(client_params=[], server_side=None, st=None,
                      client=None)
        return pstate

    def eval_params(self, ctx, pstate):
        return pstate["params"]


# ---------------------------------------------------------------------------
# PSL — the paper's protocol, fused or sharded execution
# ---------------------------------------------------------------------------

def lm_plan_batches(data: List[np.ndarray], pop, plan, seq_len: int,
                    aggregation: str, shard_of_client: np.ndarray,
                    seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Host LM batches for one epoch plan (the plan-driven token pipeline).

    Per step, each client contributes its next B_k^t locally-shuffled
    sequences, slots are grouped by the contributing client's home data
    shard, the final ragged step is padded with weight-0 slots, and
    per-slot aggregation weights are broadcast over the sequence axis.
    ``repro``'s numpy code, copied: the same (plan, seed) gives the same
    batches, bit for bit.
    """
    rng = np.random.default_rng(seed)
    orders = [rng.permutation(len(d)) for d in data]
    cursors = np.zeros(len(data), np.int64)
    b = plan.global_batch_size
    for t in range(plan.num_steps):
        seg_ids, seg_cnts = plan.step_segments(t)
        seg_ids = np.asarray(seg_ids, np.int64)
        rows, ids, cnt_runs = [], [], []
        for j in np.argsort(shard_of_client[seg_ids], kind="stable"):
            k = int(seg_ids[j])
            n = int(seg_cnts[j])
            idx = orders[k][cursors[k]:cursors[k] + n]
            cursors[k] += n
            rows.append(data[k][idx])
            ids.append(np.full(n, k))
            cnt_runs.append(np.full(n, n))
        toks = np.concatenate(rows)
        cids = np.concatenate(ids)
        slot_cnts = np.concatenate(cnt_runs)
        if toks.shape[0] < b:
            pad = b - toks.shape[0]
            toks = np.concatenate(
                [toks, np.zeros((pad, toks.shape[1]), toks.dtype)])
            cids = np.concatenate([cids, np.full(pad, -1)])
            slot_cnts = np.concatenate([slot_cnts, np.ones(pad, np.int64)])
        w = slot_weights_segments(cids, slot_cnts, pop.dataset_sizes,
                                  aggregation)
        yield {"tokens": toks[:, :seq_len].astype(np.int32),
               "labels": toks[:, 1:seq_len + 1].astype(np.int32),
               "weights": np.repeat(w[:, None], seq_len, 1)}


@register_protocol("psl")
class PSLStrategy(ProtocolStrategy):
    """Parallel split learning with global batch composition from an
    epoch plan (UGS / LDS / FPLS / FLS via repro_torch.core.sampling; the
    vectorized planner engine plans on the run's device)."""

    def _sharded(self, ctx) -> bool:
        return (ctx.execution.engine == "sharded"
                or ctx.data.kind == "synthetic_lm")

    def setup(self, ctx) -> Dict[str, Any]:
        if not self._sharded(ctx):
            return {"state": _fresh_state(ctx),
                    "step": make_train_step(ctx.model, ctx.optimizer),
                    "engine": None}
        from repro_torch.launch.distributed import (ShardedPSLEngine,
                                                    assign_clients_to_shards)
        engine = ShardedPSLEngine(
            ctx.model, ctx.optimizer,
            mesh=ctx.mesh if ctx.mesh is not None else ctx.execution.mesh,
            profile=ctx.execution.sharding,
            lowering=ctx.execution.lowering,
            microbatches=ctx.execution.microbatches, device=ctx.device)
        num_clients = (len(ctx.data.lm_data)
                       if ctx.data.kind == "synthetic_lm"
                       else ctx.data.store.num_clients)
        # one card starts from _fresh_state, as every protocol does; on a
        # mesh each rank draws the whole tree and keeps its blocks
        state = (_fresh_state(ctx) if engine.mesh is None
                 else engine.init_state(ctx.seed))
        return {"state": state, "engine": engine,
                "shard_of_client": assign_clients_to_shards(
                    num_clients, engine.num_shards)}

    def plan_epoch(self, ctx, epoch: int):
        return sampling_lib.make_plan(
            ctx.sampler.method, ctx.data.pop,
            ctx.protocol.global_batch_size, seed=ctx.seed + epoch,
            backend=ctx.sampler.backend,
            plan_format=ctx.sampler.plan_format, device=ctx.device,
            **ctx.sampler.kwargs)

    def epoch_batches(self, ctx, pstate, plan, epoch) -> Iterator[StepItem]:
        engine = pstate["engine"]
        if engine is None:
            it = GlobalBatchIterator(ctx.data.store, plan,
                                     ctx.protocol.aggregation,
                                     seed=ctx.seed * 1000 + epoch)
            for gb in it:
                yield StepItem(batch_from(gb["features"], gb["labels"],
                                          gb["weights"], device=ctx.device))
        elif ctx.data.kind == "synthetic_lm":
            for host in lm_plan_batches(ctx.data.lm_data, ctx.data.pop,
                                        plan, ctx.data.seq_len,
                                        ctx.protocol.aggregation,
                                        pstate["shard_of_client"],
                                        seed=ctx.seed + epoch):
                yield StepItem(engine.put_batch(host))
        else:
            for gb in GlobalBatchIterator(ctx.data.store, plan,
                                          ctx.protocol.aggregation,
                                          seed=ctx.seed * 1000 + epoch,
                                          num_shards=engine.num_shards):
                info = None
                if ctx.protocol.track_tpe:
                    from repro_torch.launch.distributed import step_timing
                    tm = step_timing(plan.step_sizes(gb["step"]),
                                     ctx.data.pop.delays,
                                     pstate["shard_of_client"],
                                     engine.num_shards,
                                     base_step_ms=ctx.protocol.base_step_ms)
                    info = {"step_ms": tm.step_ms,
                            "shard_skew_ms": tm.shard_skew_ms}
                batch = engine.put_batch({
                    "images": gb["features"], "labels": gb["labels"],
                    "weights": gb["weights"]})
                yield StepItem(batch, info=info)

    def step(self, ctx, pstate, item: StepItem):
        if pstate["engine"] is None:
            pstate["state"], metrics = pstate["step"](pstate["state"],
                                                      item.batch)
        else:
            pstate["state"], metrics = pstate["engine"].step(
                pstate["state"], item.batch)
        return pstate, metrics

    def eval_params(self, ctx, pstate):
        engine = pstate.get("engine")
        if engine is None:
            return pstate["state"].params
        return engine.gather_params(pstate["state"].params)

    def finalize(self, ctx, pstate, record):
        engine = pstate.get("engine")
        if engine is not None:
            record.extras["sharding_fallbacks"] = engine.report.fallbacks
