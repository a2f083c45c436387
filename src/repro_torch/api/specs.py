"""Declarative run specifications (port of :mod:`repro.api.specs`).

The schema is ``repro``'s, field for field, so one ExperimentSpec or
ServeSpec JSON document drives both packages::

    spec = ExperimentSpec.from_json(pathlib.Path("spec.json").read_text())
    result = repro_torch.api.run(spec)            # RunResult

    spec = ServeSpec.from_json(pathlib.Path("serve.json").read_text())
    report = repro_torch.api.run(spec)            # ServeReport

``to_dict``/``from_dict``/``to_json``/``from_json`` round-trip exactly;
``from_dict`` rejects unknown keys so stale configs fail loudly. Values
the port does not run yet (other archs, engines, protocols, data
kinds) fail validation or construction with a "not ported" error.
"""
from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Dict, List, Optional


class SpecError(ValueError):
    """Raised for malformed or semantically invalid specifications."""


def _unwrap_optional(tp):
    """Optional[X] -> X (passes every other type annotation through)."""
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


@dataclasses.dataclass(frozen=True)
class SpecBase:
    """Shared (de)serialization for every spec node.

    Nested spec fields are discovered from type annotations, so subclasses
    only declare fields; ``from_dict`` recurses, type-checks dicts against
    annotations, and rejects unknown keys.
    """

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, SpecBase):
                v = v.to_dict()
            elif isinstance(v, dict):
                v = dict(v)
            elif isinstance(v, list):
                v = [x.to_dict() if isinstance(x, SpecBase) else x
                     for x in v]
            out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SpecBase":
        if not isinstance(d, dict):
            raise SpecError(f"{cls.__name__}: expected a dict, got "
                            f"{type(d).__name__}")
        hints = typing.get_type_hints(cls)
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise SpecError(f"{cls.__name__}: unknown field(s) "
                            f"{sorted(unknown)}; known: {sorted(names)}")
        kwargs: Dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            tp = _unwrap_optional(hints[f.name])
            if isinstance(tp, type) and issubclass(tp, SpecBase) \
                    and v is not None:
                v = tp.from_dict(v)
            elif typing.get_origin(tp) is list and v is not None:
                args = typing.get_args(tp)
                if args and isinstance(args[0], type) \
                        and issubclass(args[0], SpecBase):
                    v = [args[0].from_dict(x) if isinstance(x, dict) else x
                         for x in v]
            kwargs[f.name] = v
        return cls(**kwargs)

    def replace(self, **changes) -> "SpecBase":
        return dataclasses.replace(self, **changes)

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "SpecBase":
        return cls.from_dict(json.loads(text))

    # -- validation helpers --------------------------------------------

    def _require(self, cond: bool, msg: str) -> None:
        if not cond:
            raise SpecError(f"{type(self).__name__}: {msg}")

    def validate(self) -> "SpecBase":
        return self


@dataclasses.dataclass(frozen=True)
class ModelSpec(SpecBase):
    """Which model to build: a config-registry arch + field overrides."""
    arch: str = "paper-cnn"
    reduced: bool = True
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def validate(self) -> "ModelSpec":
        from repro_torch.configs import _MODULES
        self._require(self.arch in _MODULES,
                      f"arch {self.arch!r} is not ported to repro_torch "
                      f"yet; ported: {sorted(_MODULES)}")
        return self


@dataclasses.dataclass(frozen=True)
class StragglerSpec(SpecBase):
    """Paper Sec. V-B straggler injection: P(straggler) and delay range."""
    p_straggler: float = 0.2
    w_min: float = 100.0
    w_max: float = 500.0
    seed: int = 0

    def validate(self) -> "StragglerSpec":
        self._require(0.0 <= self.p_straggler <= 1.0,
                      "p_straggler must be in [0, 1]")
        self._require(self.w_min <= self.w_max, "w_min must be <= w_max")
        return self


@dataclasses.dataclass(frozen=True)
class ObsSpec(SpecBase):
    """Telemetry (repro_torch.obs): span tracing, event log, invariant monitors.

    Off by default — a disabled run goes through the no-op
    ``repro_torch.obs.trace.NullTracer`` and must be bitwise-identical (losses)
    / token-identical (serving) to an instrumented one. ``trace_path``
    writes the Chrome trace-event/Perfetto JSON; ``events_path`` the
    structured JSONL event log (spans + GPSL monitor records);
    ``monitor`` arms the live GPSL invariant monitors on plan-driven
    training runs (``monitor_delta`` is the whole-epoch false-alarm mass
    of the Serfling deviation check); ``jax_profiler_dir`` (the name is
    ``repro``'s) wraps the run in ``torch.profiler`` and writes one Chrome
    trace JSON into that directory.
    """
    enabled: bool = False
    trace_path: Optional[str] = None
    events_path: Optional[str] = None
    monitor: bool = True
    monitor_delta: float = 0.05
    jax_profiler_dir: Optional[str] = None

    def validate(self) -> "ObsSpec":
        self._require(0.0 < self.monitor_delta < 1.0,
                      "monitor_delta must be in (0, 1)")
        return self


@dataclasses.dataclass(frozen=True)
class OptimizerSpec(SpecBase):
    """Optimizer family + hyperparameters (repro_torch.optim)."""
    name: str = "sgd"
    lr: float = 5e-2
    momentum: float = 0.9
    weight_decay: float = 5e-4
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def validate(self) -> "OptimizerSpec":
        self._require(self.name in ("sgd", "adamw"),
                      f"unknown optimizer {self.name!r}")
        self._require(self.lr > 0, "lr must be positive")
        return self


@dataclasses.dataclass(frozen=True)
class DataSpec(SpecBase):
    """Dataset synthesis + federation layout.

    kind "synthetic_classification": CIFAR-like images partitioned across
    ``num_clients`` ("iid" or extended-"dirichlet"); kind "synthetic_lm":
    style-skewed token sequences (one shard per client).
    """
    kind: str = "synthetic_classification"
    num_train: int = 3000
    num_test: int = 600
    image_size: int = 16
    num_classes: int = 10
    seed: int = 0
    test_seed: int = 99
    partition: str = "dirichlet"
    num_clients: int = 8
    classes_per_client: int = 2
    concentration: float = 0.3
    partition_seed: int = 1
    straggler: Optional[StragglerSpec] = None
    # synthetic_lm only
    sequences: int = 2048
    seq_len: int = 128

    def validate(self) -> "DataSpec":
        self._require(self.kind in ("synthetic_classification",
                                    "synthetic_lm"),
                      f"unknown data kind {self.kind!r}")
        self._require(self.partition in ("iid", "dirichlet"),
                      f"unknown partition {self.partition!r}")
        self._require(self.num_clients > 0, "num_clients must be positive")
        self._require(self.num_train > 0, "num_train must be positive")
        if self.straggler is not None:
            self.straggler.validate()
        return self


@dataclasses.dataclass(frozen=True)
class SamplerSpec(SpecBase):
    """Global sampling policy (repro_torch.core.sampling.make_plan
    arguments). ``backend``: "numpy" (the host reference), "jax" (the
    vectorized engine, which in the port runs in torch on the run's
    device; the name is ``repro``'s) or "auto" (that engine from 4096
    clients on). ``plan_format``: "dense", "sparse" or "auto" (default);
    draws are format-independent. ``kwargs`` go to the sampler (LDS:
    ``delta``, ``tau``, ``reinit``, ...)."""
    method: str = "ugs"
    backend: str = "numpy"
    plan_format: str = "auto"
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def validate(self) -> "SamplerSpec":
        self._require(self.method in ("ugs", "lds", "fpls", "fls"),
                      f"unknown sampling method {self.method!r}")
        self._require(self.backend in ("numpy", "jax", "auto"),
                      f"unknown planner backend {self.backend!r}")
        self._require(self.plan_format in ("dense", "sparse", "auto"),
                      f"unknown plan format {self.plan_format!r}")
        return self


@dataclasses.dataclass(frozen=True)
class ProtocolSpec(SpecBase):
    """Training protocol and its schedule.

    ``name`` selects a registered strategy (repro_torch.api.registry).
    ``batch_size`` is the per-client/local batch size of CL/SL/FL/SFL; PSL
    composes global batches of ``global_batch_size`` slots instead.
    """
    name: str = "psl"
    epochs: int = 6
    global_batch_size: int = 64
    batch_size: int = 64
    aggregation: str = "global_mean"
    local_epochs: Optional[int] = None    # FL; None = paper App. A rule
    track_tpe: bool = False
    base_step_ms: float = 60.0

    def validate(self) -> "ProtocolSpec":
        from repro_torch.api.registry import available_protocols
        self._require(self.name in available_protocols(),
                      f"unknown protocol {self.name!r}; registered: "
                      f"{available_protocols()}")
        self._require(self.epochs > 0, "epochs must be positive")
        self._require(self.global_batch_size > 0 and self.batch_size > 0,
                      "batch sizes must be positive")
        self._require(self.aggregation in ("global_mean", "client_weighted"),
                      f"unknown aggregation {self.aggregation!r}")
        return self


@dataclasses.dataclass(frozen=True)
class ExecutionSpec(SpecBase):
    """Where and how the step runs: engine, mesh, lowering, microbatches.

    engine "fused" runs the fused step on the context's device; "sharded"
    runs it through repro_torch.launch.distributed.ShardedPSLEngine on a
    (data x model) mesh of ranks (``mesh`` "DxM" or "auto"; None = every
    running rank on ``data``, one card in a single process), laid out by
    the ``sharding`` profile. ``tp`` with ``model > 1`` is tensor-parallel
    compute for the dense and VLM families (the engine refuses the
    families it does not compute in parallel: the spec knows no family).
    """
    engine: str = "fused"
    mesh: Optional[str] = None
    sharding: str = "tp"
    lowering: str = "gspmd"
    microbatches: int = 1
    max_steps: Optional[int] = None
    checkpoint: Optional[str] = None

    def validate(self) -> "ExecutionSpec":
        self._require(self.engine in ("fused", "sharded"),
                      f"unknown engine {self.engine!r}")
        self._require(self.sharding in ("tp", "fsdp", "ddp"),
                      f"unknown sharding profile {self.sharding!r}")
        self._require(self.lowering in ("gspmd", "shard_map"),
                      f"unknown lowering {self.lowering!r}")
        self._require(self.microbatches >= 1,
                      "microbatches must be >= 1")
        if self.mesh is not None:
            from repro_torch.launch.mesh import parse_mesh_spec
            try:
                parse_mesh_spec(self.mesh)
            except ValueError as e:
                raise SpecError(str(e)) from None
        return self


@dataclasses.dataclass(frozen=True)
class EvalSpec(SpecBase):
    """Held-out evaluation cadence (classification workloads)."""
    enabled: bool = True
    batch_size: int = 512
    every: int = 1

    def validate(self) -> "EvalSpec":
        self._require(self.batch_size > 0, "batch_size must be positive")
        self._require(self.every >= 1, "every must be >= 1")
        return self


@dataclasses.dataclass(frozen=True)
class ExperimentSpec(SpecBase):
    """The root: one experiment, fully pinned, JSON round-trippable."""
    seed: int = 0
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    optimizer: OptimizerSpec = dataclasses.field(
        default_factory=OptimizerSpec)
    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    sampler: SamplerSpec = dataclasses.field(default_factory=SamplerSpec)
    protocol: ProtocolSpec = dataclasses.field(default_factory=ProtocolSpec)
    execution: ExecutionSpec = dataclasses.field(
        default_factory=ExecutionSpec)
    eval: EvalSpec = dataclasses.field(default_factory=EvalSpec)
    obs: ObsSpec = dataclasses.field(default_factory=ObsSpec)
    kind: str = "experiment"        # run(spec) / load_any_spec dispatch tag

    def validate(self) -> "ExperimentSpec":
        self._require(self.kind == "experiment",
                      f"kind must be 'experiment', got {self.kind!r}")
        for sub in (self.model, self.optimizer, self.data, self.sampler,
                    self.protocol, self.execution, self.eval, self.obs):
            sub.validate()
        if self.data.kind == "synthetic_lm":
            self._require(self.protocol.name == "psl",
                          "synthetic_lm data requires the psl protocol")
        if self.execution.engine == "sharded":
            self._require(self.protocol.name == "psl",
                          "the sharded engine only lowers the psl protocol")
        return self


# ---------------------------------------------------------------------------
# Serving specs: one ServeSpec pins one serving workload end to end
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EngineSpec(SpecBase):
    """Which serve engine runs the workload, and its pool geometry.

    ``name`` selects a registered engine ("continuous" slot-pool runtime or
    the "static" A/B baseline). ``num_slots`` defaults to the admission
    token budget (falling back to the workload size) and ``slot_len`` to
    the workload's max prompt + max output length; ``seed`` initializes
    params when the spec carries no checkpoint.
    """
    name: str = "continuous"
    num_slots: Optional[int] = None
    slot_len: Optional[int] = None
    seed: int = 0

    def validate(self) -> "EngineSpec":
        from repro_torch.api.registry import available_engines
        self._require(self.name in available_engines(),
                      f"unknown engine {self.name!r}; registered: "
                      f"{available_engines()}")
        self._require(self.num_slots is None or self.num_slots >= 1,
                      "num_slots must be >= 1 (or null)")
        self._require(self.slot_len is None or self.slot_len >= 2,
                      "slot_len must be >= 2 (or null)")
        return self


@dataclasses.dataclass(frozen=True)
class TenantSpec(SpecBase):
    """One serving tenant: identity, budget-share weight, priority class.

    ``share`` is a relative weight: every scheduler step the fixed global
    token budget is apportioned across tenants proportionally to the
    weights (largest-remainder, so the integer shares sum *exactly* to the
    budget — the GPSL invariant applied across tenants). ``priority``
    orders tenants within a step: higher-priority tenants admit first,
    are preempted last, and win apportionment ties.
    """
    name: str = "default"
    share: float = 1.0
    priority: int = 0

    def validate(self) -> "TenantSpec":
        self._require(bool(self.name), "tenant name must be non-empty")
        self._require(self.share > 0, "share must be positive")
        return self


@dataclasses.dataclass(frozen=True)
class AdmissionSpec(SpecBase):
    """Admission control: the GPSL invariant, served.

    ``policy`` selects a registered controller ("budget" holds the per-step
    decode token budget fixed; "tenant" additionally partitions that budget
    into per-tenant shares — see :class:`TenantSpec`); ``token_budget``
    defaults to the engine's slot count. ``max_admits_per_step`` optionally
    throttles how many freed-budget grants one scheduler iteration may
    prefill. ``tenants`` declares the tenant population for the "tenant"
    policy; ``preempt`` lets the scheduler requeue a tenant's over-share
    requests (they resume token-identically from their emitted prefix).
    """
    policy: str = "budget"
    token_budget: Optional[int] = None
    max_admits_per_step: Optional[int] = None
    tenants: Optional[List[TenantSpec]] = None
    preempt: bool = True

    def validate(self) -> "AdmissionSpec":
        from repro_torch.api.registry import available_admission_policies
        self._require(self.policy in available_admission_policies(),
                      f"unknown admission policy {self.policy!r}; "
                      f"registered: {available_admission_policies()}")
        self._require(self.token_budget is None or self.token_budget >= 1,
                      "token_budget must be >= 1 (or null)")
        self._require(self.max_admits_per_step is None
                      or self.max_admits_per_step >= 1,
                      "max_admits_per_step must be >= 1 (or null)")
        if self.policy == "tenant":
            self._require(bool(self.tenants),
                          "the 'tenant' admission policy needs a non-empty "
                          "tenants list")
        if self.tenants is not None:
            self._require(len(self.tenants) >= 1,
                          "tenants must be non-empty (or null)")
            names = [t.name for t in self.tenants]
            self._require(len(set(names)) == len(names),
                          f"duplicate tenant names: {names}")
            for t in self.tenants:
                t.validate()
        return self


@dataclasses.dataclass(frozen=True)
class SchedulerSpec(SpecBase):
    """Admission-order policy ("fifo" arrival-fair, "ljf" longest-job-first;
    extend via repro_torch.api.register_scheduler_policy)."""
    policy: str = "fifo"

    def validate(self) -> "SchedulerSpec":
        from repro_torch.api.registry import available_scheduler_policies
        self._require(self.policy in available_scheduler_policies(),
                      f"unknown scheduler policy {self.policy!r}; "
                      f"registered: {available_scheduler_policies()}")
        return self


@dataclasses.dataclass(frozen=True)
class ArrivalSpec(SpecBase):
    """Open-loop arrival process for the request trace.

    Generates the per-request arrival times (seconds, scheduler clock)
    with one of the traffic shapes million-user serving sees
    (repro_torch.runtime.workload): "poisson" — memoryless at ``rate_per_s``;
    "bursty" — on/off bursts of mean size ``burst_size`` whose in-burst
    rate is ``burst_factor`` × the base rate; "diurnal" — a sinusoidal
    day/night rate cycle of period ``period_s`` and modulation ``depth``;
    "heavy_tail" — Pareto(``alpha``) inter-arrivals normalized to the
    base rate. All are O(n), seeded, and deterministic, so million-request
    traces replay exactly on a VirtualClock.
    """
    process: str = "poisson"
    rate_per_s: float = 200.0
    burst_factor: float = 8.0
    burst_size: float = 16.0
    period_s: float = 10.0
    depth: float = 0.8
    alpha: float = 1.5
    seed: int = 0

    def validate(self) -> "ArrivalSpec":
        self._require(self.process in ("poisson", "bursty", "diurnal",
                                       "heavy_tail"),
                      f"unknown arrival process {self.process!r}")
        self._require(self.rate_per_s > 0, "rate_per_s must be positive")
        self._require(self.burst_factor >= 1.0,
                      "burst_factor must be >= 1")
        self._require(self.burst_size >= 1.0, "burst_size must be >= 1")
        self._require(self.period_s > 0, "period_s must be positive")
        self._require(0.0 <= self.depth < 1.0, "depth must be in [0, 1)")
        self._require(self.alpha > 1.0,
                      "alpha must be > 1 (finite-mean Pareto)")
        return self


@dataclasses.dataclass(frozen=True)
class WorkloadSpec(SpecBase):
    """The synthetic request trace: sizes drawn per request from the
    ``prompt_lens`` × ``max_new_tokens`` menus (seeded), with optional
    straggler arrival delays (``arrivals`` reuses the training-side
    StragglerSpec; ``time_scale`` converts its ms into scheduler seconds),
    an optional open-loop ``arrival`` process (:class:`ArrivalSpec` —
    bursty/diurnal/heavy-tail traffic), and an optional ``tenant_mix``
    mapping tenant name → traffic weight that tags each request with a
    tenant identity (seeded draw; weights need not be normalized).
    """
    num_requests: int = 8
    prompt_lens: List[int] = dataclasses.field(
        default_factory=lambda: [32])
    max_new_tokens: List[int] = dataclasses.field(
        default_factory=lambda: [16])
    seed: int = 0
    arrivals: Optional[StragglerSpec] = None
    time_scale: float = 1e-3
    arrival: Optional[ArrivalSpec] = None
    tenant_mix: Optional[Dict[str, float]] = None

    def validate(self) -> "WorkloadSpec":
        self._require(self.num_requests > 0, "num_requests must be positive")
        self._require(bool(self.prompt_lens)
                      and all(p >= 1 for p in self.prompt_lens),
                      "prompt_lens must be a non-empty list of lengths >= 1")
        self._require(bool(self.max_new_tokens)
                      and all(m >= 1 for m in self.max_new_tokens),
                      "max_new_tokens must be a non-empty list of "
                      "lengths >= 1")
        self._require(self.time_scale > 0, "time_scale must be positive")
        self._require(not (self.arrivals is not None
                           and self.arrival is not None),
                      "set either straggler `arrivals` or an `arrival` "
                      "process, not both")
        if self.arrivals is not None:
            self.arrivals.validate()
        if self.arrival is not None:
            self.arrival.validate()
        if self.tenant_mix is not None:
            self._require(bool(self.tenant_mix),
                          "tenant_mix must be non-empty (or null)")
            self._require(all(w > 0 for w in self.tenant_mix.values()),
                          "tenant_mix weights must be positive")
        return self


@dataclasses.dataclass(frozen=True)
class CacheSpec(SpecBase):
    """Paged KV-cache geometry (the ``paged`` engine; repro_torch.runtime.paging).

    ``page_size`` is the fixed page length in token positions;
    ``num_pages`` is the pool's physical page count and defaults to
    ``num_slots * ceil(slot_len / page_size)`` — same worst-case token
    capacity as the slot pool, so slot-vs-page comparisons are
    apples-to-apples and the paged win shows up as *in-use* bytes, not a
    smaller ceiling. Provision fewer pages to cap memory below worst
    case; admission then holds free pages >= next-step demand (the GPSL
    invariant restated in pages) and the engine preempts to stay inside
    the pool. Ignored by the ``continuous``/``static`` engines.
    """
    page_size: int = 16
    num_pages: Optional[int] = None

    def validate(self) -> "CacheSpec":
        self._require(self.page_size >= 1, "page_size must be >= 1")
        self._require(self.num_pages is None or self.num_pages >= 1,
                      "num_pages must be >= 1 (or null)")
        return self


@dataclasses.dataclass(frozen=True)
class SamplingSpec(SpecBase):
    """Token selection per decode step (repro_torch.runtime.sampling).

    ``method`` is "greedy" (argmax — the reference_generate oracle's
    choice, required by ``report.verify``) or "sample": temperature
    softmax optionally truncated by top_k and/or nucleus top_p. Sampled
    draws are keyed by ``(seed, rid, token_index)`` — not by engine
    state — so the same spec reproduces the same tokens across runs,
    across engines (paged vs continuous), and across preempt/resume
    boundaries.
    """
    method: str = "greedy"
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0

    def validate(self) -> "SamplingSpec":
        self._require(self.method in ("greedy", "sample"),
                      f"unknown sampling method {self.method!r}; "
                      f"known: greedy, sample")
        self._require(self.temperature > 0, "temperature must be positive")
        self._require(self.top_k is None or self.top_k >= 1,
                      "top_k must be >= 1 (or null)")
        self._require(self.top_p is None or 0 < self.top_p <= 1,
                      "top_p must be in (0, 1] (or null)")
        return self


@dataclasses.dataclass(frozen=True)
class DraftSpec(SpecBase):
    """Draft model for the ``speculative`` engine (repro.runtime.spec_decode).

    The draft proposes ``gamma`` lookahead tokens per active request;
    one batched target step then verifies the whole window. Exactly one
    of two draft sources must be set:

    * ``num_layers`` — a truncated-layer view of the target: the draft
      reuses the target's first N layers (and embeddings/head), so for
      every verified token its per-layer KV is *identical* to the
      target's and the draft attends straight over the target's pages —
      the fork shares physical KV, not just table entries. N equal to
      the target's depth is the self-draft degenerate case (100%
      acceptance; useful for tests).
    * ``arch`` — a configs entry served as an independent draft model
      (same vocab required; own page buffers over the same page-id
      space, params from ``seed``).
    """
    arch: Optional[str] = None
    num_layers: Optional[int] = None
    gamma: int = 4
    reduced: bool = True
    seed: int = 0

    @property
    def configured(self) -> bool:
        return self.arch is not None or self.num_layers is not None

    def validate(self) -> "DraftSpec":
        self._require(self.gamma >= 1, "draft.gamma must be >= 1")
        self._require(not (self.arch is not None
                           and self.num_layers is not None),
                      "draft.arch and draft.num_layers are exclusive "
                      "draft sources; set one")
        self._require(self.num_layers is None or self.num_layers >= 1,
                      "draft.num_layers must be >= 1 (or null)")
        return self


@dataclasses.dataclass(frozen=True)
class StreamSpec(SpecBase):
    """Token streaming surface (engine ``on_token`` hook; api/serving.py).

    When enabled, every engine emission — the prefill's first token,
    plain decode steps, and accepted speculative bursts alike — flows
    through one per-token hook: instants land on the request's obs
    track, ``path`` (optional) collects a JSONL stream sink, and
    ``verify_report`` audits that stream order equals the final
    per-request token order.
    """
    enabled: bool = False
    path: Optional[str] = None

    def validate(self) -> "StreamSpec":
        self._require(self.path is None or self.enabled,
                      "stream.path needs stream.enabled=true")
        return self


@dataclasses.dataclass(frozen=True)
class ClockSpec(SpecBase):
    """Scheduler clock: "wall" (real time, idle waits sleep) or "virtual"
    (deterministic tick per engine operation — replayable tests)."""
    kind: str = "wall"
    tick_s: float = 1e-3

    def validate(self) -> "ClockSpec":
        self._require(self.kind in ("wall", "virtual"),
                      f"unknown clock kind {self.kind!r}")
        self._require(self.tick_s > 0, "tick_s must be positive")
        return self


@dataclasses.dataclass(frozen=True)
class ReportSpec(SpecBase):
    """Report handling: ``verify`` checks N continuous outputs (-1 = all)
    token-identical against single-request decoding; ``out`` writes the
    report JSON (without per-request rows unless ``per_request``)."""
    verify: int = 0
    per_request: bool = True
    out: Optional[str] = None

    def validate(self) -> "ReportSpec":
        self._require(self.verify >= -1,
                      "verify must be -1 (all), 0 (off), or a count")
        return self


@dataclasses.dataclass(frozen=True)
class ServeSpec(SpecBase):
    """The root: one serving workload, fully pinned, JSON round-trippable.

    ``checkpoint`` optionally references a params artifact emitted by a
    training run (``ExperimentSpec.execution.checkpoint`` →
    ``repro.checkpoint``), closing the train→serve loop: the served model
    is the trained one, not a fresh init.
    """
    kind: str = "serve"             # run(spec) / load_any_spec dispatch tag
    model: ModelSpec = dataclasses.field(
        default_factory=lambda: ModelSpec(arch="granite-3-2b"))
    engine: EngineSpec = dataclasses.field(default_factory=EngineSpec)
    admission: AdmissionSpec = dataclasses.field(
        default_factory=AdmissionSpec)
    scheduler: SchedulerSpec = dataclasses.field(
        default_factory=SchedulerSpec)
    workload: WorkloadSpec = dataclasses.field(
        default_factory=WorkloadSpec)
    cache: CacheSpec = dataclasses.field(default_factory=CacheSpec)
    sampling: SamplingSpec = dataclasses.field(
        default_factory=SamplingSpec)
    draft: DraftSpec = dataclasses.field(default_factory=DraftSpec)
    stream: StreamSpec = dataclasses.field(default_factory=StreamSpec)
    clock: ClockSpec = dataclasses.field(default_factory=ClockSpec)
    report: ReportSpec = dataclasses.field(default_factory=ReportSpec)
    obs: ObsSpec = dataclasses.field(default_factory=ObsSpec)
    checkpoint: Optional[str] = None

    # -- derived geometry (the None-default resolution chain) ----------

    def resolved_num_slots(self) -> int:
        if self.engine.num_slots is not None:
            return self.engine.num_slots
        if self.admission.token_budget is not None:
            return self.admission.token_budget
        return self.workload.num_requests

    def resolved_slot_len(self) -> int:
        if self.engine.slot_len is not None:
            return self.engine.slot_len
        return (max(self.workload.prompt_lens)
                + max(self.workload.max_new_tokens))

    def resolved_num_pages(self) -> int:
        if self.cache.num_pages is not None:
            return self.cache.num_pages
        p = self.cache.page_size
        return self.resolved_num_slots() * -(-self.resolved_slot_len() // p)

    def validate(self) -> "ServeSpec":
        self._require(self.kind == "serve",
                      f"kind must be 'serve', got {self.kind!r}")
        for sub in (self.model, self.engine, self.admission, self.scheduler,
                    self.workload, self.cache, self.sampling, self.draft,
                    self.stream, self.clock, self.report, self.obs):
            sub.validate()
        self._require(self.model.arch != "paper-cnn",
                      "serving needs a decoder LM arch, not the "
                      "classification CNN")
        if (self.admission.token_budget is not None
                and self.engine.num_slots is not None):
            self._require(
                self.admission.token_budget <= self.engine.num_slots,
                "token_budget exceeds num_slots: budgeted slots must exist")
        if self.engine.slot_len is not None:
            self._require(
                self.resolved_slot_len()
                >= max(self.workload.prompt_lens)
                + max(self.workload.max_new_tokens),
                "slot_len too small for the workload's max prompt + max "
                "new tokens")
        if self.workload.tenant_mix is not None \
                and self.admission.tenants is not None:
            known = {t.name for t in self.admission.tenants}
            stray = set(self.workload.tenant_mix) - known
            self._require(not stray,
                          f"tenant_mix names {sorted(stray)} not declared "
                          f"in admission.tenants {sorted(known)}")
        if self.engine.name == "static":
            self._require(self.report.verify == 0,
                          "verify requires the continuous engine "
                          "(left-padded static batches are not "
                          "token-identical; docs/serving.md)")
            self._require(self.workload.arrivals is None
                          and self.workload.arrival is None,
                          "the static engine assembles its batch up front "
                          "and cannot honor arrival traces")
            self._require(self.admission.tenants is None,
                          "the static engine has no per-request admission "
                          "and cannot serve multi-tenant shares")
        if self.report.verify:
            self._require(self.sampling.method == "greedy",
                          "verify compares against greedy single-request "
                          "decoding; sampling.method must be 'greedy'")
        if self.engine.name == "static":
            self._require(self.sampling.method == "greedy",
                          "the static engine decodes greedily only")
        if self.engine.name in ("paged", "speculative"):
            worst = (max(self.workload.prompt_lens)
                     + max(self.workload.max_new_tokens))
            self._require(
                self.resolved_num_pages() * self.cache.page_size >= worst,
                f"paged pool too small: num_pages*page_size must cover one "
                f"worst-case request ({worst} tokens), or eviction can "
                f"never free enough pages to finish it")
        if self.engine.name == "speculative":
            self._require(self.draft.configured,
                          "the speculative engine needs a draft source: "
                          "set draft.num_layers (truncated-layer view) or "
                          "draft.arch (configs entry)")
        return self
