"""Materialize a spec and run it: ``repro_torch.api.run(spec)`` (port of
:mod:`repro.api.runner`).

``run`` dispatches on the spec kind: an :class:`ExperimentSpec` builds the
model, optimizer and data bundle it describes on the requested device,
picks the registered protocol strategy, wires the default callbacks (plan
stats / shard arrival timing / checkpoint) and drives the shared training
loop; a :class:`ServeSpec` routes to :func:`repro_torch.api.serving.
run_serve`. Everything runs on the CUDA card unless ``device="cpu"``::

    run(ExperimentSpec.from_json(text))                  # on the card
    run(ExperimentSpec.from_json(text), device="cpu")    # tests
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.api import events as events_lib
from repro_torch.api.loop import DataBundle, RunContext, fit
from repro_torch.api.registry import get_protocol
from repro_torch.api.serving import build_model
from repro_torch.api.specs import DataSpec, ExperimentSpec, \
    OptimizerSpec, ServeSpec, SpecError
from repro_torch.device import resolve_device

__all__ = ["build_model", "build_optimizer", "build_data",
           "default_callbacks", "build_context", "run"]


def build_optimizer(spec: OptimizerSpec):
    from repro_torch import optim
    if spec.name == "sgd":
        return optim.sgd(spec.lr, momentum=spec.momentum,
                         weight_decay=spec.weight_decay, **spec.kwargs)
    return optim.adamw(spec.lr, weight_decay=spec.weight_decay,
                       **spec.kwargs)


def build_data(spec: DataSpec, *, vocab_size: Optional[int] = None
               ) -> DataBundle:
    """Materialize the federation a DataSpec describes (numpy, seeded:
    the same spec gives ``repro``'s client shards)."""
    if spec.kind != "synthetic_lm":
        raise NotImplementedError(
            f"data kind {spec.kind!r} is not ported to repro_torch yet "
            f"(the classification data comes with the CNN slice, "
            f"ROADMAP A.3)")
    from repro_torch.data.federated import build_lm_client_store
    if vocab_size is None:
        raise ValueError("synthetic_lm data needs the model vocab size")
    data, pop = build_lm_client_store(vocab_size, spec.num_clients,
                                      spec.sequences, spec.seq_len,
                                      seed=spec.seed)
    return DataBundle(kind=spec.kind, lm_data=data, pop=pop,
                      seq_len=spec.seq_len)


def default_callbacks(spec: ExperimentSpec, data: DataBundle
                      ) -> List[events_lib.Callback]:
    """The callback set of ``repro``'s LM runs: plan stats, shard arrival
    timing, and a checkpoint when the spec names one."""
    cbs: List[events_lib.Callback] = []
    if spec.protocol.name == "psl":
        cbs.append(events_lib.PlanStatsCallback())
        cbs.append(events_lib.ShardArrivalCallback(
            track=spec.protocol.track_tpe))
    if spec.execution.checkpoint:
        cbs.append(events_lib.CheckpointCallback(spec.execution.checkpoint))
    return cbs


def build_context(spec: ExperimentSpec, device="cuda") -> RunContext:
    """Spec → built objects on ``device``, without running anything."""
    spec.validate()
    if spec.model.arch == "paper-cnn":
        raise SpecError("the paper's CNN is not ported to repro_torch yet "
                        "(ROADMAP A.3)")
    dev = resolve_device(device)
    model = build_model(spec.model, seq_len=spec.data.seq_len)
    data = build_data(spec.data, vocab_size=model.cfg.vocab_size)
    optimizer = build_optimizer(spec.optimizer)
    return RunContext(model=model, optimizer=optimizer, data=data,
                      spec=spec, seed=spec.seed, device=dev)


def run(spec, callbacks=(), ctx=None, device="cuda"):
    """Run one spec: a training RunResult or a serving ServeReport, on
    ``device`` (the CUDA card unless ``"cpu"``; a prebuilt ``ctx`` keeps
    its own device). ``callbacks`` extend the training defaults."""
    if isinstance(spec, ServeSpec):
        if callbacks:
            raise ValueError(
                "callbacks are a training-loop feature; a ServeSpec run "
                "takes none")
        from repro_torch.api.serving import run_serve
        return run_serve(spec, ctx=ctx, device=device)
    if ctx is None:
        ctx = build_context(spec, device=device)
    else:
        spec.validate()
        ctx = dataclasses.replace(ctx, spec=spec, seed=spec.seed)
    strategy = get_protocol(spec.protocol.name)()
    cbs = default_callbacks(spec, ctx.data) + list(callbacks)
    return fit(ctx, strategy, cbs)
