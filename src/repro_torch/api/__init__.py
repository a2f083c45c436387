"""`repro_torch.api` — the declarative API of the port (mirrors
:mod:`repro.api`): one ExperimentSpec or ServeSpec JSON pins a run,
registries map names to protocols, engines and policies, and :func:`run`
drives either kind on the CUDA card (``device="cpu"`` for tests)."""
from repro_torch.api.cli import apply_overrides, load_any_spec, parse_set
from repro_torch.api.evaluation import batch_from, evaluate
from repro_torch.api.events import (Callback, CheckpointCallback,
                                    ConsoleLogger, EvalCallback, Event,
                                    EventBus, PlanStatsCallback,
                                    ShardArrivalCallback,
                                    StragglerTPECallback)
from repro_torch.api.loop import (DataBundle, History, RunContext,
                                  RunRecord, RunResult, fit)
from repro_torch.api.registry import (ProtocolStrategy, StepItem,
                                      UnknownPolicyError,
                                      UnknownProtocolError,
                                      available_admission_policies,
                                      available_engines,
                                      available_protocols,
                                      available_scheduler_policies,
                                      get_admission_policy, get_engine,
                                      get_protocol, get_scheduler_policy,
                                      register_admission_policy,
                                      register_engine, register_protocol,
                                      register_scheduler_policy)
from repro_torch.api.runner import (build_context, build_data,
                                    build_optimizer, default_callbacks, run)
from repro_torch.api.serving import (ServeContext, audit_stream,
                                     build_model, build_serve_context,
                                     build_workload, restore_params,
                                     run_serve, verify_report)
from repro_torch.api.specs import (AdmissionSpec, ArrivalSpec, CacheSpec,
                                   ClockSpec, DataSpec, DraftSpec,
                                   EngineSpec, EvalSpec, ExecutionSpec,
                                   ExperimentSpec, ModelSpec, ObsSpec,
                                   OptimizerSpec, ProtocolSpec, ReportSpec,
                                   SamplerSpec, SamplingSpec, SchedulerSpec,
                                   ServeSpec, SpecError, StragglerSpec,
                                   StreamSpec, TenantSpec, WorkloadSpec)

__all__ = [
    "ExperimentSpec", "ModelSpec", "OptimizerSpec", "DataSpec",
    "SamplerSpec", "ProtocolSpec", "ExecutionSpec", "EvalSpec",
    "ServeSpec", "EngineSpec", "AdmissionSpec",
    "SchedulerSpec", "WorkloadSpec", "ClockSpec", "ReportSpec", "TenantSpec",
    "ArrivalSpec", "CacheSpec", "SamplingSpec", "DraftSpec", "StreamSpec",
    "ObsSpec", "StragglerSpec", "SpecError",
    "run", "build_context", "build_data", "build_optimizer",
    "default_callbacks", "fit", "RunContext", "RunRecord", "RunResult",
    "History", "DataBundle",
    "Event", "EventBus", "Callback", "EvalCallback", "PlanStatsCallback",
    "StragglerTPECallback", "ShardArrivalCallback", "CheckpointCallback",
    "ConsoleLogger", "batch_from", "evaluate",
    "register_protocol", "get_protocol", "available_protocols",
    "ProtocolStrategy", "StepItem", "UnknownProtocolError",
    "run_serve", "build_serve_context", "build_workload",
    "build_model", "ServeContext", "restore_params", "verify_report",
    "audit_stream",
    "register_scheduler_policy", "get_scheduler_policy",
    "available_scheduler_policies",
    "register_admission_policy", "get_admission_policy",
    "available_admission_policies",
    "register_engine", "get_engine", "available_engines",
    "UnknownPolicyError", "apply_overrides", "parse_set", "load_any_spec",
]
