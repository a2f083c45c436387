"""The training loop behind every entry point of the port (port of
:mod:`repro.api.loop`).

``fit(ctx, strategy, callbacks)`` drives a registered protocol strategy:
per epoch it asks the strategy for a plan, iterates the strategy's batch
stream, applies the strategy's step, runs the end-of-epoch aggregation
hook, and emits events (run_begin / epoch_begin / plan / step_end /
epoch_end / run_end) that callbacks turn into evaluation, plan
statistics, straggler accounting and checkpoints.
``repro_torch.api.run`` builds the context from an ExperimentSpec.

Telemetry (``ctx.spec.obs``, repro_torch.obs): when enabled, the loop
wraps each phase in tracer spans — ``plan`` (epoch planning), ``batch``
(host batch assembly, one per step), ``device_step`` (the strategy's
step; the PSL engine's step waits for the card, so the span covers its
device work) and ``eval`` (end-of-epoch callbacks) under per-epoch
``epoch`` spans inside one ``run`` span, and feeds each step's plan
segment to the live GPSL invariant monitor (repro_torch.obs.monitor),
whose per-epoch summaries land in ``record.extras["gpsl_monitor"]``.
Instrumentation touches no RNG and no batch content. With
``obs.jax_profiler_dir`` set, the whole run is traced by
``torch.profiler`` (``repro_torch.obs.maybe_profiler``). On a mesh of
ranks every rank runs the loop; only rank 0 writes the trace, the event
log and the profiler's trace.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.api.events import EventBus
from repro_torch.api.registry import ProtocolStrategy
from repro_torch.launch.mesh import is_main_process
from repro_torch.obs import (maybe_profiler, monitor_from_spec,
                             tracer_from_spec, write_outputs)


@dataclasses.dataclass
class History:
    """Per-epoch test accuracy + protocol extras (the stable result API)."""
    test_acc: List[float]
    extras: Dict[str, Any]

    @property
    def best(self) -> float:
        return max(self.test_acc) if self.test_acc else 0.0


@dataclasses.dataclass
class DataBundle:
    """The materialized data a run consumes.

    ``train`` is the pooled (features, labels) (CL); ``store`` the
    federated ClientStore (SL/FL/SFL/PSL); ``lm_data`` per-client token
    arrays (synthetic_lm); ``test`` the held-out (features, labels) or
    None; ``pop`` the ClientPopulation.
    """
    kind: str = "synthetic_classification"
    train: Optional[Tuple] = None
    test: Optional[Tuple] = None
    store: Any = None
    lm_data: Optional[List] = None
    pop: Any = None
    seq_len: Optional[int] = None       # synthetic_lm: training seq length

    @classmethod
    def from_store(cls, store, test=None, train=None):
        return cls(store=store, test=test, train=train,
                   pop=store.population if store is not None else None)


@dataclasses.dataclass
class RunContext:
    """Everything a strategy may consult: built objects + the spec axes,
    and the torch device the run uses."""
    model: Any
    optimizer: Any
    data: DataBundle
    spec: Any                       # ExperimentSpec
    seed: int = 0
    device: Any = None
    mesh: Any = None                # prebuilt DeviceMesh (sharded engine)

    @property
    def protocol(self):
        return self.spec.protocol

    @property
    def sampler(self):
        return self.spec.sampler

    @property
    def execution(self):
        return self.spec.execution


@dataclasses.dataclass
class RunRecord:
    """Mutable sink the loop and callbacks write into."""
    test_acc: List[float] = dataclasses.field(default_factory=list)
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)
    step_metrics: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    steps: int = 0


@dataclasses.dataclass
class RunResult:
    """What a run returns: the History plus final params and step metrics."""
    history: History
    params: Any
    step_metrics: List[Dict[str, float]]
    state: Any = None               # final protocol state (engine access)

    @property
    def test_acc(self) -> List[float]:
        return self.history.test_acc

    @property
    def best(self) -> float:
        return self.history.best


_END = object()                       # batch-stream exhaustion sentinel


def fit(ctx: RunContext, strategy: ProtocolStrategy,
        callbacks=(), tracer=None) -> RunResult:
    """Run ``strategy`` under ``ctx`` for ``ctx.protocol.epochs`` epochs.

    ``tracer`` defaults to one built from ``ctx.spec.obs`` (the shared
    no-op NullTracer when absent or disabled).
    """
    obs = getattr(ctx.spec, "obs", None)
    if tracer is None:
        tracer = tracer_from_spec(
            obs, meta={"kind": "train",
                       "protocol": getattr(ctx.protocol, "name", "?")})
    record = RunRecord()
    bus = EventBus(callbacks, ctx, record)
    pstate = strategy.setup(ctx)
    max_steps = ctx.execution.max_steps
    bus.emit("run_begin")
    stop = False
    pop = getattr(ctx.data, "pop", None)
    with maybe_profiler(obs if is_main_process() else None, ctx.device), \
            tracer.span("run", cat="train"):
        for epoch in range(ctx.protocol.epochs):
            with tracer.span("epoch", cat="train", epoch=epoch):
                bus.emit("epoch_begin", epoch=epoch)
                with tracer.span("plan", cat="plan", epoch=epoch):
                    plan = strategy.plan_epoch(ctx, epoch)
                if plan is not None:
                    bus.emit("plan", epoch=epoch, plan=plan)
                monitor = None
                if plan is not None and pop is not None:
                    monitor = monitor_from_spec(
                        obs, pop, plan.global_batch_size, epoch=epoch,
                        num_steps=plan.num_steps, tracer=tracer)
                epoch_step = 0
                batches = iter(strategy.epoch_batches(ctx, pstate, plan,
                                                      epoch))
                while True:
                    with tracer.span("batch", cat="data", epoch=epoch):
                        item = next(batches, _END)
                    if item is _END:
                        break
                    if monitor is not None \
                            and epoch_step < plan.num_steps:
                        monitor.observe_plan_step(plan, epoch_step)
                    with tracer.span("device_step", cat="step",
                                     epoch=epoch, step=record.steps):
                        pstate, metrics = strategy.step(ctx, pstate, item)
                    record.step_metrics.append(metrics)
                    record.steps += 1
                    epoch_step += 1
                    bus.emit("step_end", epoch=epoch, step=record.steps,
                             metrics=metrics, info=item.info)
                    if max_steps is not None and record.steps >= max_steps:
                        stop = True
                        break
                if monitor is not None:
                    summary = monitor.finish()
                    record.extras.setdefault("gpsl_monitor", []).append(
                        summary.to_dict())
                pstate = strategy.end_epoch(ctx, pstate, epoch)
                with tracer.span("eval", cat="eval", epoch=epoch):
                    bus.emit("epoch_end", epoch=epoch,
                             params=strategy.eval_params(ctx, pstate))
            if stop:
                break
        strategy.finalize(ctx, pstate, record)
        params = strategy.eval_params(ctx, pstate)
        bus.emit("run_end", params=params)
    if is_main_process():
        write_outputs(tracer, obs)
    step_metrics = [{k: float(v) for k, v in m.items()}
                    for m in record.step_metrics]
    return RunResult(history=History(record.test_acc, record.extras),
                     params=params, step_metrics=step_metrics,
                     state=pstate)
