"""Materialize a spec and run it: ``repro_torch.api.run(spec)`` (port of
:mod:`repro.api.runner`).

``run`` dispatches on the spec kind: an :class:`ExperimentSpec` builds the
model, optimizer and data bundle it describes on the requested device,
picks the registered protocol strategy, wires the default callbacks (eval
/ plan stats / straggler timing / checkpoint) and drives the shared
training loop; a :class:`ServeSpec` routes to :func:`repro_torch.api.serving.
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
    OptimizerSpec, ServeSpec
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
    the same spec gives ``repro``'s datasets, partitions, delays and
    client shards, bit for bit)."""
    if spec.kind == "synthetic_lm":
        from repro_torch.data.federated import build_lm_client_store
        if vocab_size is None:
            raise ValueError("synthetic_lm data needs the model vocab size")
        data, pop = build_lm_client_store(vocab_size, spec.num_clients,
                                          spec.sequences, spec.seq_len,
                                          seed=spec.seed)
        return DataBundle(kind=spec.kind, lm_data=data, pop=pop,
                          seq_len=spec.seq_len)

    from repro_torch.core.partition import partition_dirichlet, \
        partition_iid
    from repro_torch.data.federated import ClientStore
    from repro_torch.data.synthetic import make_classification_dataset
    features, labels = make_classification_dataset(
        spec.num_train, num_classes=spec.num_classes,
        image_size=spec.image_size, seed=spec.seed)
    test = make_classification_dataset(
        spec.num_test, num_classes=spec.num_classes,
        image_size=spec.image_size, seed=spec.test_seed)
    if spec.partition == "iid":
        parts, pop = partition_iid(labels, spec.num_clients,
                                   spec.num_classes,
                                   seed=spec.partition_seed)
    else:
        parts, pop = partition_dirichlet(
            labels, spec.num_clients, spec.num_classes,
            classes_per_client=spec.classes_per_client,
            concentration=spec.concentration, seed=spec.partition_seed)
    if spec.straggler is not None:
        from repro_torch.core.straggler import assign_delays
        s = spec.straggler
        pop.delays[:] = assign_delays(spec.num_clients, s.p_straggler,
                                      s.w_min, s.w_max, seed=s.seed)
    store = ClientStore.from_partition(features, labels, parts, pop)
    return DataBundle(kind=spec.kind, train=(features, labels), test=test,
                      store=store, pop=pop)


def default_callbacks(spec: ExperimentSpec, data: DataBundle
                      ) -> List[events_lib.Callback]:
    """``repro``'s callback set: held-out evaluation, and for PSL plan
    stats plus straggler timing (analytic off the plan on the fused
    engine, per step on the sharded one and for LM data); a checkpoint
    when the spec names one."""
    cbs: List[events_lib.Callback] = []
    if spec.eval.enabled and data.test is not None:
        cbs.append(events_lib.EvalCallback(every=spec.eval.every,
                                           batch_size=spec.eval.batch_size))
    if spec.protocol.name == "psl":
        cbs.append(events_lib.PlanStatsCallback())
        if spec.execution.engine == "sharded" \
                or data.kind == "synthetic_lm":
            cbs.append(events_lib.ShardArrivalCallback(
                track=spec.protocol.track_tpe))
        else:
            cbs.append(events_lib.StragglerTPECallback(
                base_step_ms=spec.protocol.base_step_ms,
                track=spec.protocol.track_tpe))
    if spec.execution.checkpoint:
        cbs.append(events_lib.CheckpointCallback(spec.execution.checkpoint))
    return cbs


def build_context(spec: ExperimentSpec, device="cuda") -> RunContext:
    """Spec → built objects on ``device``, without running anything."""
    spec.validate()
    dev = resolve_device(device)
    model = build_model(spec.model, seq_len=spec.data.seq_len)
    data = build_data(spec.data,
                      vocab_size=getattr(model.cfg, "vocab_size", None))
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
