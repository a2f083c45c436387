"""Name -> implementation registries for protocols and serving policies
(port of :mod:`repro.api.registry`).

* **Protocol strategies** (``@register_protocol``) package a training
  protocol's epoch planning, batch assembly, step and aggregation hook
  behind one interface driven by :func:`repro_torch.api.loop.fit`. The
  port registers ``repro``'s five: ``cl``, ``sl``, ``fl``, ``sfl`` and
  ``psl``.
* **Serving policies**: admission order (``@register_scheduler_policy``),
  the budget controller (``@register_admission_policy``) and the engine
  itself (``@register_engine``).

Built-ins register as an import side effect of their home module
(:mod:`repro_torch.api.protocols`, :mod:`repro_torch.runtime`), imported
lazily on first lookup.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, Iterator, List, Optional, Tuple, Type


class UnknownProtocolError(KeyError):
    """Lookup of a protocol name that was never registered."""


class UnknownPolicyError(KeyError):
    """Lookup of a serving policy/engine name that was never registered."""


class _Registry:
    """One name → implementation table with lazy built-in loading."""

    def __init__(self, kind: str, builtins_module: str, error_cls):
        self.kind = kind
        self._builtins_module = builtins_module
        self._error_cls = error_cls
        self._loaded = False
        self._entries: Dict[str, Any] = {}

    def register(self, name: str, *, replace: bool = False):
        """Decorator: make a class reachable by ``name`` (sets ``cls.name``)."""
        def deco(obj):
            if name in self._entries and not replace:
                raise ValueError(
                    f"{self.kind} {name!r} already registered "
                    f"({self._entries[name].__name__}); pass replace=True "
                    f"to override")
            obj.name = name
            self._entries[name] = obj
            return obj
        return deco

    def get(self, name: str):
        self._ensure_builtins()
        try:
            return self._entries[name]
        except KeyError:
            raise self._error_cls(
                f"unknown {self.kind} {name!r}; registered: "
                f"{self.available()}") from None

    def available(self) -> List[str]:
        self._ensure_builtins()
        return sorted(self._entries)

    def pop(self, name: str, default=None):
        """Remove an entry (test cleanup for throwaway registrations)."""
        return self._entries.pop(name, default)

    def _ensure_builtins(self) -> None:
        # registering the built-ins is an import side effect of the home
        # module; import lazily so registry<->implementation cycles never
        # form at module load. A flag, not an emptiness check: a custom
        # entry registered before the first lookup must not shadow the
        # built-ins.
        if not self._loaded:
            self._loaded = True
            importlib.import_module(self._builtins_module)


_PROTOCOLS = _Registry("protocol", "repro_torch.api.protocols",
                       UnknownProtocolError)
# importing the repro_torch.runtime package pulls in queue/scheduler/
# engine/paging, which registers every built-in serving policy and engine
_SCHEDULER_POLICIES = _Registry("scheduler policy", "repro_torch.runtime",
                                UnknownPolicyError)
_ADMISSION_POLICIES = _Registry("admission policy", "repro_torch.runtime",
                                UnknownPolicyError)
_ENGINES = _Registry("serve engine", "repro_torch.runtime",
                     UnknownPolicyError)


def register_protocol(name: str, *, replace: bool = False):
    """Class decorator: make a :class:`ProtocolStrategy` reachable by name."""
    return _PROTOCOLS.register(name, replace=replace)


def get_protocol(name: str) -> Type["ProtocolStrategy"]:
    return _PROTOCOLS.get(name)


def available_protocols() -> List[str]:
    return _PROTOCOLS.available()


def register_scheduler_policy(name: str, *, replace: bool = False):
    """Class decorator: an admission-order policy (``order(ready)``)."""
    return _SCHEDULER_POLICIES.register(name, replace=replace)


def get_scheduler_policy(name: str):
    return _SCHEDULER_POLICIES.get(name)


def available_scheduler_policies() -> List[str]:
    return _SCHEDULER_POLICIES.available()


def register_admission_policy(name: str, *, replace: bool = False):
    """Class decorator: a budget controller (``grants``/``note_step``)."""
    return _ADMISSION_POLICIES.register(name, replace=replace)


def get_admission_policy(name: str):
    return _ADMISSION_POLICIES.get(name)


def available_admission_policies() -> List[str]:
    return _ADMISSION_POLICIES.available()


def register_engine(name: str, *, replace: bool = False):
    """Class decorator: a serve engine (``from_spec``/``serve``)."""
    return _ENGINES.register(name, replace=replace)


def get_engine(name: str):
    return _ENGINES.get(name)


def available_engines() -> List[str]:
    return _ENGINES.available()


class StepItem:
    """One unit of work yielded by a strategy's batch assembly: ``batch``
    is what the strategy's ``step`` consumes; ``scope`` tags a
    sub-context (None for global streams); ``info`` carries per-step
    diagnostics forwarded to callbacks on the step event."""

    __slots__ = ("batch", "scope", "info")

    def __init__(self, batch: Any, scope: Any = None,
                 info: Optional[Dict[str, Any]] = None):
        self.batch = batch
        self.scope = scope
        self.info = info


class ProtocolStrategy:
    """Interface the shared loop (repro_torch.api.loop.fit) drives. Per
    epoch::

        plan  = strategy.plan_epoch(ctx, epoch)           # may be None
        for item in strategy.epoch_batches(ctx, pstate, plan, epoch):
            pstate, metrics = strategy.step(ctx, pstate, item)
        pstate = strategy.end_epoch(ctx, pstate, epoch)   # aggregation hook
    """

    name: str = "?"

    def setup(self, ctx) -> Any:
        raise NotImplementedError

    def plan_epoch(self, ctx, epoch: int):
        return None

    def epoch_batches(self, ctx, pstate, plan, epoch: int
                      ) -> Iterator[StepItem]:
        raise NotImplementedError

    def step(self, ctx, pstate, item: StepItem) -> Tuple[Any, Dict]:
        raise NotImplementedError

    def end_epoch(self, ctx, pstate, epoch: int) -> Any:
        return pstate

    def eval_params(self, ctx, pstate) -> Any:
        raise NotImplementedError

    def finalize(self, ctx, pstate, record) -> None:
        """Last hook before run_end; may write protocol extras."""
