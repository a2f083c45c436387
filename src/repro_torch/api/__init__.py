"""`repro_torch.api` — the declarative serving API of the port (mirrors
the serving half of :mod:`repro.api`): one ServeSpec JSON pins a run,
registries map names to engines and policies, and :func:`run_serve`
drives every engine."""
from repro_torch.api.cli import apply_overrides, load_any_spec, parse_set
from repro_torch.api.registry import (UnknownPolicyError,
                                      available_admission_policies,
                                      available_engines,
                                      available_scheduler_policies,
                                      get_admission_policy, get_engine,
                                      get_scheduler_policy,
                                      register_admission_policy,
                                      register_engine,
                                      register_scheduler_policy)
from repro_torch.api.serving import (ServeContext, audit_stream,
                                     build_model, build_serve_context,
                                     build_workload, restore_params,
                                     run_serve, verify_report)
from repro_torch.api.specs import (AdmissionSpec, ArrivalSpec, CacheSpec,
                                   ClockSpec, DraftSpec, EngineSpec,
                                   ModelSpec, ObsSpec, ReportSpec,
                                   SamplingSpec, SchedulerSpec, ServeSpec,
                                   SpecError, StragglerSpec, StreamSpec,
                                   TenantSpec, WorkloadSpec)

__all__ = [
    "ServeSpec", "ModelSpec", "EngineSpec", "AdmissionSpec",
    "SchedulerSpec", "WorkloadSpec", "ClockSpec", "ReportSpec", "TenantSpec",
    "ArrivalSpec", "CacheSpec", "SamplingSpec", "DraftSpec", "StreamSpec",
    "ObsSpec", "StragglerSpec", "SpecError",
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
