"""Run events and callbacks of the training loop (port of
:mod:`repro.api.events`).

The shared loop emits typed events; callbacks subscribe to them and write
their outputs into the run record. Events (in emission order):
  run_begin | epoch_begin | plan | step_end | epoch_end | run_end
``plan`` fires once per epoch for plan-driven protocols (payload: the
epoch plan); ``step_end`` carries the step metrics plus any
strategy-supplied ``info`` (e.g. straggler arrival timing from the
sharded engine). Evaluation, plan statistics, straggler timing (analytic
off the plan for the fused engine, per step for the sharded one),
checkpointing and console logging are all callbacks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class Event:
    name: str
    epoch: Optional[int] = None
    step: Optional[int] = None
    plan: Any = None
    metrics: Optional[Dict[str, Any]] = None
    params: Any = None
    info: Optional[Dict[str, Any]] = None


class Callback:
    """Base callback: override ``on_event``; ``record`` is the RunRecord."""

    def on_event(self, event: Event, ctx, record) -> None:
        raise NotImplementedError


class EventBus:
    def __init__(self, callbacks, ctx, record):
        self.callbacks = list(callbacks)
        self.ctx = ctx
        self.record = record

    def emit(self, name: str, **payload) -> None:
        ev = Event(name=name, **payload)
        for cb in self.callbacks:
            cb.on_event(ev, self.ctx, self.record)


class EvalCallback(Callback):
    """Held-out accuracy on epoch_end -> record.test_acc."""

    def __init__(self, every: int = 1, batch_size: int = 512):
        self.every = every
        self.batch_size = batch_size

    def on_event(self, event, ctx, record):
        if event.name != "epoch_end" or ctx.data.test is None:
            return
        if (event.epoch + 1) % self.every:
            return
        from repro_torch.api.evaluation import evaluate
        feats, labs = ctx.data.test
        record.test_acc.append(evaluate(ctx.model, event.params, feats,
                                        labs, batch_size=self.batch_size))


class PlanStatsCallback(Callback):
    """Accumulates sampler statistics (EM iterations) off the plan event."""

    def on_event(self, event, ctx, record):
        if event.name == "run_begin":
            record.extras.setdefault("em_iterations", 0)
        elif event.name == "plan" and event.plan is not None:
            record.extras["em_iterations"] += event.plan.em_iterations


class StragglerTPECallback(Callback):
    """Analytic epoch TPE from the plan + client delays (fused engine).

    Streams the plan's ``step_segments`` (never the dense (T, K) matrix),
    so it costs O(active clients) per step and works on sparse plans.
    With ``track=False`` only the empty ``tpe_ms`` extras slot is created
    (the stable result shape) and nothing is simulated.
    """

    def __init__(self, base_step_ms: float = 60.0, track: bool = True):
        self.base_step_ms = base_step_ms
        self.track = track

    def on_event(self, event, ctx, record):
        if event.name == "run_begin":
            record.extras.setdefault("tpe_ms", [])
        elif self.track and event.name == "plan" \
                and event.plan is not None:
            from repro_torch.core.straggler import simulate_tpe_segments
            record.extras["tpe_ms"].append(simulate_tpe_segments(
                event.plan, ctx.data.pop.delays,
                base_step_ms=self.base_step_ms).total_ms)


class ShardArrivalCallback(Callback):
    """Per-step straggler arrival timing from the sharded engine: consumes
    the ``info`` dicts a strategy attaches to each step ({"step_ms",
    "shard_skew_ms"}) and records per-epoch TPE plus the per-step shard
    arrival skew."""

    def __init__(self, track: bool = True):
        self.track = track
        self._epoch_ms = 0.0

    def on_event(self, event, ctx, record):
        if event.name == "run_begin":
            record.extras.setdefault("tpe_ms", [])
            record.extras.setdefault("shard_skew_ms", [])
        elif event.name == "epoch_begin":
            self._epoch_ms = 0.0
        elif event.name == "step_end" and event.info:
            self._epoch_ms += event.info["step_ms"]
            record.extras["shard_skew_ms"].append(
                event.info["shard_skew_ms"])
        elif event.name == "epoch_end" and self.track:
            record.extras["tpe_ms"].append(self._epoch_ms)


class CheckpointCallback(Callback):
    """Saves eval params at run_end (and optionally every N epochs) in
    ``repro``'s npz format. The eval params are whole on every rank of a
    mesh; rank 0 writes them."""

    def __init__(self, path: str, every: Optional[int] = None):
        self.path = path
        self.every = every

    def _save(self, params):
        from repro_torch.checkpoint import save
        from repro_torch.launch.mesh import is_main_process
        if is_main_process():
            save(self.path, params)

    def on_event(self, event, ctx, record):
        if event.name == "epoch_end" and self.every \
                and (event.epoch + 1) % self.every == 0:
            self._save(event.params)
        elif event.name == "run_end":
            self._save(event.params)
            record.extras["checkpoint"] = self.path


class ConsoleLogger(Callback):
    """Step/epoch progress lines (the launch CLI's output format), printed
    by rank 0 of a mesh."""

    def __init__(self, every: int = 10):
        self.every = every
        self._epoch_steps = 0

    def on_event(self, event, ctx, record):
        from repro_torch.launch.mesh import is_main_process
        if not is_main_process():
            return
        if event.name == "epoch_begin":
            self._epoch_steps = 0
        elif event.name == "step_end":
            i = self._epoch_steps
            self._epoch_steps += 1
            if i % self.every == 0 and event.metrics is not None:
                m = {k: float(v) for k, v in event.metrics.items()}
                print(f"  epoch {event.epoch} step {i:4d} "
                      f"loss={m.get('loss', float('nan')):.4f} "
                      f"acc={m.get('accuracy', float('nan')):.3f} "
                      f"gnorm={m.get('grad_norm', float('nan')):.2f}",
                      flush=True)
        elif event.name == "epoch_end" and record.test_acc:
            print(f"epoch {event.epoch}: test_acc="
                  f"{record.test_acc[-1]:.4f}", flush=True)
