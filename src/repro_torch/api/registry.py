"""Name -> implementation registries for the serving policies (port of
the serving half of :mod:`repro.api.registry`).

The server-side axes of the continuous-batching runtime are pluggable:
admission order (``@register_scheduler_policy``), the budget controller
(``@register_admission_policy``) and the engine itself
(``@register_engine``). Built-ins register as an import side effect of
:mod:`repro_torch.runtime`, imported lazily on first lookup.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, List


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


# importing the repro_torch.runtime package pulls in queue/scheduler/
# engine/paging, which registers every built-in serving policy and engine
_SCHEDULER_POLICIES = _Registry("scheduler policy", "repro_torch.runtime",
                                UnknownPolicyError)
_ADMISSION_POLICIES = _Registry("admission policy", "repro_torch.runtime",
                                UnknownPolicyError)
_ENGINES = _Registry("serve engine", "repro_torch.runtime",
                     UnknownPolicyError)


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
