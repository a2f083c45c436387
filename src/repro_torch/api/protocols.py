"""Built-in protocol strategies of the port: PSL (port of the PSL half of
:mod:`repro.api.protocols`).

PSL is the paper's protocol: every epoch the server plans the global
batches (UGS / FPLS / FLS via :mod:`repro_torch.core.sampling`), each
step gathers the planned sequences from the clients
(:func:`lm_plan_batches`) and runs the fused step. As in ``repro``,
every LM workload goes through the engine of
:mod:`repro_torch.launch.distributed` (``repro``'s PSLStrategy sends
``synthetic_lm`` data to its ShardedPSLEngine whatever
``execution.engine`` says). The classification path (fused CNN step,
GlobalBatchIterator) comes with the CNN slice (ROADMAP A.3).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List

import numpy as np

from repro_torch.api.registry import ProtocolStrategy, StepItem, \
    register_protocol
from repro_torch.core import sampling as sampling_lib
from repro_torch.core.psl import slot_weights_segments


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
    epoch plan; LM workloads on the one-card engine."""

    def setup(self, ctx) -> Dict[str, Any]:
        if ctx.data.kind != "synthetic_lm":
            raise NotImplementedError(
                f"psl on {ctx.data.kind!r} data is not ported to "
                f"repro_torch yet (the CNN slice, ROADMAP A.3)")
        from repro_torch.launch.distributed import (ShardedPSLEngine,
                                                    assign_clients_to_shards)
        # execution.sharding lays parameters out across cards; on the one
        # card of this engine every profile is the same step
        engine = ShardedPSLEngine(
            ctx.model, ctx.optimizer, mesh=ctx.execution.mesh,
            lowering=ctx.execution.lowering,
            microbatches=ctx.execution.microbatches, device=ctx.device)
        return {"state": engine.init_state(ctx.seed), "engine": engine,
                "shard_of_client": assign_clients_to_shards(
                    len(ctx.data.lm_data), engine.num_shards)}

    def plan_epoch(self, ctx, epoch: int):
        return sampling_lib.make_plan(
            ctx.sampler.method, ctx.data.pop,
            ctx.protocol.global_batch_size, seed=ctx.seed + epoch,
            backend=ctx.sampler.backend,
            plan_format=ctx.sampler.plan_format, **ctx.sampler.kwargs)

    def epoch_batches(self, ctx, pstate, plan, epoch) -> Iterator[StepItem]:
        engine = pstate["engine"]
        for host in lm_plan_batches(ctx.data.lm_data, ctx.data.pop, plan,
                                    ctx.data.seq_len,
                                    ctx.protocol.aggregation,
                                    pstate["shard_of_client"],
                                    seed=ctx.seed + epoch):
            yield StepItem(engine.put_batch(host))

    def step(self, ctx, pstate, item: StepItem):
        pstate["state"], metrics = pstate["engine"].step(pstate["state"],
                                                         item.batch)
        return pstate, metrics

    def eval_params(self, ctx, pstate):
        return pstate["state"].params

    def finalize(self, ctx, pstate, record):
        # one card: no sharding profile can fall back
        record.extras["sharding_fallbacks"] = []
