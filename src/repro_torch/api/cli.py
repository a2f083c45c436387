"""Dotted-override plumbing for the train and serve CLIs (port of
:mod:`repro.api.cli`).

``parse_set`` parses one ``key=value`` item (value via JSON, falling back
to a bare string); ``apply_overrides`` walks the dotted path through the
spec tree, validating every segment against the dataclass schema except
inside free-form dict leaves, and returns a new spec of the same kind.
``load_any_spec`` loads a spec JSON and dispatches on its ``kind``
(``"experiment"``, the default, or ``"serve"``), reading ``repro``'s
JSON of either kind.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, Tuple, Union

from repro_torch.api.specs import ExperimentSpec, ServeSpec, SpecError

AnySpec = Union[ExperimentSpec, ServeSpec]

# the only free-form dict leaves in the spec tree
_FREE_FORM = ("kwargs", "overrides")


def parse_set(item: str) -> Tuple[str, Any]:
    """"a.b.c=VALUE" -> ("a.b.c", parsed VALUE)."""
    key, sep, raw = item.partition("=")
    if not sep or not key:
        raise SpecError(f"override {item!r} is not of the form key=value")
    try:
        value = json.loads(raw)
    except json.JSONDecodeError:
        value = raw
    return key, value


def _set_dotted(tree: Dict[str, Any], key: str, value: Any) -> None:
    parts = key.split(".")
    node = tree
    in_schema = True
    for i, p in enumerate(parts[:-1]):
        if p not in node:
            if in_schema:
                raise SpecError(
                    f"override path {key!r}: unknown field {p!r} "
                    f"(known: {sorted(node)})")
            node[p] = {}
        if not isinstance(node[p], dict):
            raise SpecError(
                f"override path {key!r}: {'.'.join(parts[:i + 1])!r} "
                f"is a leaf, not a section")
        in_schema = in_schema and p not in _FREE_FORM
        node = node[p]
    leaf = parts[-1]
    if in_schema and leaf not in node:
        raise SpecError(f"override path {key!r}: unknown field {leaf!r} "
                        f"(known: {sorted(node)})")
    node[leaf] = value


def apply_overrides(spec: AnySpec, sets: Iterable[str]) -> AnySpec:
    """Apply ``key=value`` dotted overrides, returning a new spec."""
    d = spec.to_dict()
    for item in sets:
        key, value = parse_set(item)
        _set_dotted(d, key, value)
    return type(spec).from_dict(d)


_SPEC_KINDS = {"experiment": ExperimentSpec, "serve": ServeSpec}


def load_any_spec(path: str) -> AnySpec:
    """Load a spec JSON of either kind (``kind`` field; default
    "experiment", as in ``repro``)."""
    with open(path) as f:
        d = json.load(f)
    if not isinstance(d, dict):
        raise SpecError(f"{path}: expected a JSON object")
    kind = d.get("kind", "experiment")
    if kind not in _SPEC_KINDS:
        raise SpecError(f"{path}: unknown spec kind {kind!r}; known: "
                        f"{sorted(_SPEC_KINDS)}")
    return _SPEC_KINDS[kind].from_dict(d)
