"""Dotted-override plumbing for the serve CLI (port of the serving half
of :mod:`repro.api.cli`).

``parse_set`` parses one ``key=value`` item (value via JSON, falling back
to a bare string); ``apply_overrides`` walks the dotted path through the
spec tree, validating every segment against the dataclass schema except
inside free-form dict leaves, and returns a new spec. ``load_any_spec``
loads a spec JSON and dispatches on its ``kind``; the port serves
``"serve"`` specs only.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, Tuple

from repro_torch.api.specs import ServeSpec, SpecError

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


def apply_overrides(spec: ServeSpec, sets: Iterable[str]) -> ServeSpec:
    """Apply ``key=value`` dotted overrides, returning a new spec."""
    d = spec.to_dict()
    for item in sets:
        key, value = parse_set(item)
        _set_dotted(d, key, value)
    return type(spec).from_dict(d)


def load_any_spec(path: str) -> ServeSpec:
    """Load a spec JSON; training (``"experiment"``) specs are not ported
    yet and raise."""
    with open(path) as f:
        d = json.load(f)
    if not isinstance(d, dict):
        raise SpecError(f"{path}: expected a JSON object")
    kind = d.get("kind", "experiment")
    if kind != "serve":
        raise SpecError(f"{path}: spec kind {kind!r} is not ported to "
                        f"repro_torch yet; the port runs 'serve' specs")
    return ServeSpec.from_dict(d)
