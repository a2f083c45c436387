"""End-to-end PSL training CLI of the port — a thin shell over
``repro_torch.api.run`` (mirrors ``repro.launch.train``).

The experiment is one ExperimentSpec (the same JSON ``repro`` reads),
loaded from ``--config spec.json`` with dotted ``--set key=value``
overrides; the convenience flags map onto spec overrides as in
``repro``. Without ``--config`` it trains full-width granite-3-2b; a
config may name any ported model, the paper's CNN (``paper-cnn``, the
spec's default arch) included, with any protocol. It runs on the CUDA
card; ``--device cpu`` runs on the CPU (meant for reduced models).

On a (data × model) mesh, one process a rank: ``--mesh DxM`` (default
``auto``: every rank on ``data``), ``--sharding tp|fsdp|ddp`` and
``--lowering gspmd|shard_map`` under ``python -m torch.distributed.run
--nproc-per-node D*M``. Each rank runs on ``cuda:(local_rank %
device_count)`` (gloo where ranks share a card, nccl where each has its
own; ``repro_torch.launch.mesh``); rank 0 prints and writes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --steps 3 --global-batch 8 --seq-len 32 --clients 8 --sequences 256
  PYTHONPATH=src python -m repro_torch.launch.train --config spec.json \\
      --set sampler.method=fpls
  echo '{"kind": "experiment"}' > cnn.json    # repro's default: PSL-UGS CNN
  PYTHONPATH=src python -m repro_torch.launch.train --config cnn.json \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --config cnn.json \\
      --device cpu --method lds --set sampler.kwargs.delta=1.5 \\
      --planner-backend jax          # LDS on the vectorized engine
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2 \\
      --sharding fsdp --reduced --device cpu --steps 3   # a mesh of ranks
"""
from __future__ import annotations

import argparse
import math
import time
from typing import List

import torch.distributed as dist

from repro_torch import api
from repro_torch.launch.mesh import is_main_process, rank_device
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import TrainState


class PSLTrainer:
    """Sharded PSL trainer over a (data × model) mesh of ranks.

    Deprecated epoch-level trainer kept for existing callers (``repro``'s
    ``PSLTrainer``): the engine lives in
    ``repro_torch.launch.distributed.ShardedPSLEngine`` and the
    plan-driven LM batch assembly in
    ``repro_torch.api.protocols.lm_plan_batches`` — the same pieces the
    "psl" strategy composes when ``repro_torch.api.run`` executes an LM
    spec. ``mesh`` None puts every running rank on ``data`` (one card in
    a single process).
    """

    def __init__(self, cfg, optimizer=None, mesh=None,
                 aggregation: str = "global_mean", profile: str = "tp",
                 lowering: str = "gspmd", microbatches: int = 1,
                 device="cuda"):
        from repro_torch import optim as optim_lib
        from repro_torch.launch.distributed import (ShardedPSLEngine,
                                                    assign_clients_to_shards)
        from repro_torch.models import build_model
        self.cfg = cfg
        self.model = build_model(cfg)
        self.optimizer = optimizer or optim_lib.adamw(1e-3)
        self.aggregation = aggregation
        self.engine = ShardedPSLEngine(self.model, self.optimizer,
                                       mesh=mesh, profile=profile,
                                       lowering=lowering,
                                       microbatches=microbatches,
                                       device=device)
        self.mesh = self.engine.mesh
        self._assign = assign_clients_to_shards
        self.report = self.engine.report

    def init_state(self, seed: int = 0) -> TrainState:
        return self.engine.init_state(seed)

    def train_epoch(self, state: TrainState, data, pop, plan,
                    seq_len: int, seed: int = 0, max_steps=None):
        """One PSL epoch from an EpochPlan over per-client token arrays."""
        from repro_torch.api.protocols import lm_plan_batches
        shard_of_client = self._assign(len(data), self.engine.num_shards)
        metrics_hist = []
        for t, host in enumerate(lm_plan_batches(
                data, pop, plan, seq_len, self.aggregation,
                shard_of_client, seed=seed)):
            if max_steps is not None and t >= max_steps:
                break
            state, metrics = self.engine.step(state,
                                              self.engine.put_batch(host))
            metrics_hist.append(dict(metrics))
        return state, metrics_hist


def default_lm_spec() -> api.ExperimentSpec:
    """The CLI's baseline spec (``repro``'s): full-width granite-3-2b,
    AdamW, 8 non-IID clients, 2048 sequences of 128 tokens, global batch
    16, UGS, 50 steps."""
    return api.ExperimentSpec(
        model=api.ModelSpec(arch="granite-3-2b", reduced=False),
        optimizer=api.OptimizerSpec(name="adamw", lr=1e-3,
                                    weight_decay=0.1),
        data=api.DataSpec(kind="synthetic_lm", num_clients=8,
                          sequences=2048, seq_len=128),
        sampler=api.SamplerSpec(method="ugs"),
        protocol=api.ProtocolSpec(name="psl", epochs=1,
                                  global_batch_size=16),
        execution=api.ExecutionSpec(engine="sharded", max_steps=50),
        eval=api.EvalSpec(enabled=False))


def _legacy_overrides(args) -> List[str]:
    """Map the convenience flags onto dotted spec overrides."""
    sets: List[str] = []

    def add(key, value):
        if value is not None:
            sets.append(f"{key}={value}")

    add("model.arch", args.arch)
    if args.reduced is not None:        # tri-state: --reduced/--no-reduced
        add("model.reduced", "true" if args.reduced else "false")
    add("execution.max_steps", args.steps)
    add("protocol.epochs", args.epochs)
    add("protocol.global_batch_size", args.global_batch)
    add("data.seq_len", args.seq_len)
    add("data.num_clients", args.clients)
    add("data.sequences", args.sequences)
    add("sampler.method", args.method)
    add("sampler.backend", args.planner_backend)
    add("sampler.plan_format", args.plan_format)
    add("protocol.aggregation", args.aggregation)
    add("execution.mesh", args.mesh)
    add("execution.sharding", args.sharding)
    add("execution.lowering", args.lowering)
    add("execution.microbatches", args.microbatches)
    add("optimizer.lr", args.lr)
    add("execution.checkpoint", args.checkpoint)
    add("seed", args.seed)
    add("data.seed", args.seed)
    if args.d_model:
        add("model.overrides.d_model", args.d_model)
        add("model.overrides.num_heads", max(4, args.d_model // 64))
        add("model.overrides.num_kv_heads", max(2, args.d_model // 128))
        add("model.overrides.d_ff", args.d_model * 4)
    if args.layers:
        add("model.overrides.num_layers", args.layers)
    return sets


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None, metavar="SPEC_JSON",
                    help="ExperimentSpec JSON file (repro's schema)")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    dest="sets", help="dotted spec override (repeatable)")
    ap.add_argument("--print-spec", action="store_true",
                    help="print the resolved spec JSON and exit")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--sequences", type=int, default=None)
    ap.add_argument("--method", default=None,
                    choices=["ugs", "lds", "fpls", "fls"])
    ap.add_argument("--planner-backend", default=None,
                    choices=["numpy", "jax", "auto"],
                    help="epoch-plan engine: numpy (host reference), jax "
                         "(the vectorized engine, torch on --device) or "
                         "auto (that engine from 4096 clients on)")
    ap.add_argument("--plan-format", default=None, dest="plan_format",
                    choices=["dense", "sparse", "auto"])
    ap.add_argument("--aggregation", default=None)
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="(data × model) mesh of ranks for the sharded "
                         "engine, e.g. '2x1' or '2x2'; default: every "
                         "rank on data. Launch D*M ranks with python -m "
                         "torch.distributed.run --nproc-per-node D*M")
    ap.add_argument("--sharding", default=None,
                    choices=["tp", "fsdp", "ddp"],
                    help="sharding profile of the parameters and moments; "
                         "tp on a mesh with model > 1 computes every LM "
                         "family tensor-parallel (heads, MLP columns, "
                         "Mamba channels, MoE experts and vocab over "
                         "model; whisper's encoder, decoder and "
                         "cross-attention alike)")
    ap.add_argument("--lowering", default=None,
                    choices=["gspmd", "shard_map"],
                    help="gspmd: each rank stores its blocks of the "
                         "state (profile layouts); shard_map: replicated "
                         "state, explicit data parallelism over data")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="gradient-accumulation slices of the global batch")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)

    if args.config:
        spec = api.load_any_spec(args.config)
        if not isinstance(spec, api.ExperimentSpec):
            raise SystemExit(f"{args.config} is a {spec.kind!r} spec; "
                             f"the train CLI needs kind 'experiment' "
                             f"(use repro_torch.launch.serve for serving)")
    else:
        spec = default_lm_spec()
    spec = api.apply_overrides(spec, _legacy_overrides(args) + args.sets)
    if args.print_spec:
        print(spec.to_json())
        return

    owns_group = not dist.is_initialized()
    ctx = api.build_context(spec, device=rank_device(args.device))
    main_rank = is_main_process()
    n_params = sum(math.prod(s.shape)
                   for s in tree_leaves(ctx.model.param_specs()))
    if main_rank:
        print(f"arch={ctx.model.cfg.name} params={n_params / 1e6:.1f}M "
              f"clients={ctx.data.pop.num_clients} "
              f"D0={ctx.data.pop.total_size} method={spec.sampler.method} "
              f"device={ctx.device}", flush=True)
    t0 = time.time()
    result = api.run(spec, callbacks=[api.ConsoleLogger(every=10)],
                     ctx=ctx)
    steps = len(result.step_metrics)
    if main_rank:
        fallbacks = result.history.extras.get("sharding_fallbacks")
        if fallbacks:
            print("sharding fallbacks:", "; ".join(fallbacks))
        if steps:
            print(f"{steps} steps in {time.time() - t0:.1f}s "
                  f"(final loss {result.step_metrics[-1]['loss']:.4f})")
        if spec.execution.checkpoint:
            print("checkpoint saved to", spec.execution.checkpoint)
    if owns_group and dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
