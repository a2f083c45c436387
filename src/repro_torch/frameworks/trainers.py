"""Legacy trainer entry points for the compared DDL frameworks (Sec. V)
(port of :mod:`repro.frameworks.trainers`).

.. deprecated::
    These six ``train_*`` functions are thin shims over the declarative
    experiment API: each one assembles a
    :class:`repro_torch.api.RunContext` from its (model, optimizer, data)
    arguments and drives the registered protocol strategy through the
    shared loop (``repro_torch.api.loop.fit``). Each emits a
    :class:`DeprecationWarning` on call; its trajectory is the one
    ``repro_torch.api.run(spec)`` gives for the equivalent spec. New code
    should build a :class:`repro_torch.api.ExperimentSpec` and call
    ``repro_torch.api.run(spec)`` instead. Like every entry point of the
    port they run on the CUDA card unless ``device="cpu"``.

      * CL   — central learning on the pooled dataset (upper baseline).
      * SL   — sequential split learning (weights hop client to client).
      * FL   — FedAvg (size-weighted average of local models).
      * SFL  — SplitFed (parallel client segments, shared server segment).
      * PSL  — parallel split learning from an EpochPlan (UGS/LDS/FPLS/FLS),
               fused on one card or sharded onto a (data × model) mesh of
               ranks.
"""
from __future__ import annotations

import functools
import warnings
from typing import Optional

from repro_torch.api import events as events_lib
from repro_torch.api.evaluation import evaluate
from repro_torch.api.loop import DataBundle, History, RunContext, fit
from repro_torch.api.registry import get_protocol
from repro_torch.api.specs import (EvalSpec, ExecutionSpec, ExperimentSpec,
                                   ProtocolSpec, SamplerSpec)
from repro_torch.data.federated import ClientStore
from repro_torch.device import resolve_device

__all__ = ["evaluate", "train_cl", "train_fl", "train_psl",
           "train_psl_sharded", "train_sfl", "train_sl"]


def _deprecated_shim(fn):
    """Stamp a trainer entry point as a shim over ``repro_torch.api.run``."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        warnings.warn(
            f"repro_torch.frameworks.trainers.{fn.__name__} is deprecated; "
            f"build a repro_torch.api.ExperimentSpec and call "
            f"repro_torch.api.run(spec) (same trajectory, one JSON document "
            f"per experiment)",
            DeprecationWarning, stacklevel=2)
        return fn(*args, **kwargs)
    return wrapper


def _shim_spec(protocol: str, *, epochs: int, batch_size: int = 64,
               global_batch_size: int = 64, method: str = "ugs",
               aggregation: str = "global_mean",
               sampler_kwargs: Optional[dict] = None,
               planner_backend: str = "numpy",
               plan_format: str = "dense",
               local_epochs: Optional[int] = None,
               track_tpe: bool = False, base_step_ms: float = 60.0,
               engine: str = "fused", sharding: str = "tp",
               lowering: str = "gspmd", microbatches: int = 1
               ) -> ExperimentSpec:
    """Spec carrying the legacy kwargs; model/optimizer/data stay objects."""
    return ExperimentSpec(
        protocol=ProtocolSpec(name=protocol, epochs=epochs,
                              batch_size=batch_size,
                              global_batch_size=global_batch_size,
                              aggregation=aggregation,
                              local_epochs=local_epochs,
                              track_tpe=track_tpe,
                              base_step_ms=base_step_ms),
        sampler=SamplerSpec(method=method, backend=planner_backend,
                            plan_format=plan_format,
                            kwargs=dict(sampler_kwargs or {})),
        execution=ExecutionSpec(engine=engine, sharding=sharding,
                                lowering=lowering,
                                microbatches=microbatches),
        eval=EvalSpec())


def _fit(model, optimizer, data: DataBundle, spec: ExperimentSpec,
         seed: int, device, extra_callbacks=(), mesh=None) -> History:
    ctx = RunContext(model=model, optimizer=optimizer, data=data,
                     spec=spec, seed=seed, device=resolve_device(device),
                     mesh=mesh)
    callbacks = [events_lib.EvalCallback()] + list(extra_callbacks)
    return fit(ctx, get_protocol(spec.protocol.name)(), callbacks).history


@_deprecated_shim
def train_cl(model, optimizer, features, labels, test, *, epochs: int,
             batch_size: int, seed: int = 0, device="cuda") -> History:
    spec = _shim_spec("cl", epochs=epochs, batch_size=batch_size)
    data = DataBundle(train=(features, labels), test=test)
    return _fit(model, optimizer, data, spec, seed, device)


@_deprecated_shim
def train_psl(model, optimizer, store: ClientStore, test, *, epochs: int,
              global_batch_size: int, method: str = "ugs",
              aggregation: str = "global_mean", seed: int = 0,
              sampler_kwargs: Optional[dict] = None,
              planner_backend: str = "numpy",
              plan_format: str = "dense",
              track_tpe: bool = False, base_step_ms: float = 60.0,
              device="cuda") -> History:
    """PSL training loop (shim). ``planner_backend`` selects the epoch-plan
    engine: "numpy" (default, the reference), "jax" (the vectorized engine
    of the port, torch on ``device``) or "auto"; ``plan_format`` dense /
    sparse / auto epoch-plan storage (batches are bit-identical across
    formats)."""
    spec = _shim_spec("psl", epochs=epochs,
                      global_batch_size=global_batch_size, method=method,
                      aggregation=aggregation,
                      sampler_kwargs=sampler_kwargs,
                      planner_backend=planner_backend,
                      plan_format=plan_format, track_tpe=track_tpe,
                      base_step_ms=base_step_ms)
    data = DataBundle.from_store(store, test=test)
    cbs = [events_lib.PlanStatsCallback(),
           events_lib.StragglerTPECallback(base_step_ms=base_step_ms,
                                           track=track_tpe)]
    return _fit(model, optimizer, data, spec, seed, device, cbs)


@_deprecated_shim
def train_psl_sharded(model, optimizer, store: ClientStore, test, *,
                      epochs: int, global_batch_size: int,
                      method: str = "ugs",
                      aggregation: str = "global_mean", seed: int = 0,
                      sampler_kwargs: Optional[dict] = None,
                      planner_backend: str = "numpy",
                      plan_format: str = "dense",
                      mesh=None, profile: str = "tp",
                      lowering: str = "gspmd", microbatches: int = 1,
                      track_tpe: bool = False, base_step_ms: float = 60.0,
                      device="cuda") -> History:
    """PSL with the fused step on a (data × model) mesh of ranks (shim).

    Same protocol as :func:`train_psl` — identical plans, batches, and
    aggregation weights — but the step runs through
    ``repro_torch.launch.distributed.ShardedPSLEngine`` (``mesh`` a
    DeviceMesh, a spec, or None: every running rank on ``data``), and with
    ``track_tpe`` the straggler accounting uses the per-shard arrival
    model.
    """
    spec = _shim_spec("psl", epochs=epochs,
                      global_batch_size=global_batch_size, method=method,
                      aggregation=aggregation,
                      sampler_kwargs=sampler_kwargs,
                      planner_backend=planner_backend,
                      plan_format=plan_format, track_tpe=track_tpe,
                      base_step_ms=base_step_ms, engine="sharded",
                      sharding=profile, lowering=lowering,
                      microbatches=microbatches)
    data = DataBundle.from_store(store, test=test)
    cbs = [events_lib.PlanStatsCallback(),
           events_lib.ShardArrivalCallback(track=track_tpe)]
    return _fit(model, optimizer, data, spec, seed, device, cbs, mesh=mesh)


@_deprecated_shim
def train_sl(model, optimizer, store: ClientStore, test, *, epochs: int,
             batch_size: int, seed: int = 0, device="cuda") -> History:
    spec = _shim_spec("sl", epochs=epochs, batch_size=batch_size)
    data = DataBundle.from_store(store, test=test)
    return _fit(model, optimizer, data, spec, seed, device)


@_deprecated_shim
def train_fl(model, optimizer, store: ClientStore, test, *, epochs: int,
             batch_size: int, local_epochs: Optional[int] = None,
             seed: int = 0, device="cuda") -> History:
    spec = _shim_spec("fl", epochs=epochs, batch_size=batch_size,
                      local_epochs=local_epochs)
    data = DataBundle.from_store(store, test=test)
    return _fit(model, optimizer, data, spec, seed, device)


@_deprecated_shim
def train_sfl(model, optimizer, store: ClientStore, test, *, epochs: int,
              batch_size: int, seed: int = 0, device="cuda") -> History:
    """SplitFed-V1 (shim): per round each client runs its local batches
    against the shared server segment; client segments are FedAvg'd at the
    end of the round."""
    spec = _shim_spec("sfl", epochs=epochs, batch_size=batch_size)
    data = DataBundle.from_store(store, test=test)
    return _fit(model, optimizer, data, spec, seed, device)
