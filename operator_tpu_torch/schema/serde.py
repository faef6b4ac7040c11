"""Dataclass <-> JSON-ish dict conversion with Kubernetes camelCase keys.

Copy of ``operator_tpu/schema/serde.py``.

The reference system's typed model layer lives in an external Maven artifact
(``com.redhat.podmortem:common``, reference pom.xml:95-99) whose Jackson
serialisation uses camelCase field names.  This module gives our dataclasses
the same wire shape: ``snake_case`` attribute names map to ``camelCase`` keys,
``None`` fields are omitted, nested dataclasses / lists / dicts / enums are
handled recursively, and unknown keys are ignored on input (Kubernetes objects
always carry fields we don't model).
"""

from __future__ import annotations

import dataclasses
import enum
import types
import typing
from typing import Any, Optional, TypeVar, Union, get_args, get_origin, get_type_hints

T = TypeVar("T")

_HINTS_CACHE: dict[type, dict[str, Any]] = {}


def snake_to_camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(part[:1].upper() + part[1:] for part in rest)


def camel_to_snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


def _type_hints(cls: type) -> dict[str, Any]:
    hints = _HINTS_CACHE.get(cls)
    if hints is None:
        hints = get_type_hints(cls)
        _HINTS_CACHE[cls] = hints
    return hints


def to_dict(obj: Any, *, drop_none: bool = True) -> Any:
    """Recursively convert a dataclass tree to plain dicts with camelCase keys."""
    if isinstance(obj, enum.Enum):  # before the scalar check: str-enums are strs
        return obj.value
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            if not f.metadata.get("serialize", True):
                continue
            value = getattr(obj, f.name)
            if value is None and drop_none:
                continue
            key = f.metadata.get("wire_name") or snake_to_camel(f.name)
            out[key] = to_dict(value, drop_none=drop_none)
        return out
    if isinstance(obj, dict):
        return {k: to_dict(v, drop_none=drop_none) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v, drop_none=drop_none) for v in obj]
    return obj


def _unwrap_optional(tp: Any) -> Any:
    origin = get_origin(tp)
    if origin is Union or origin is types.UnionType:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _coerce(value: Any, tp: Any) -> Any:
    if value is None:
        return None
    tp = _unwrap_optional(tp)
    if tp is Any or tp is None:
        return value
    origin = get_origin(tp)
    if origin in (list, tuple):
        (elem_tp,) = get_args(tp) or (Any,)
        seq = [_coerce(v, elem_tp) for v in value]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        args = get_args(tp)
        val_tp = args[1] if len(args) == 2 else Any
        return {k: _coerce(v, val_tp) for k, v in value.items()}
    if isinstance(tp, type):
        if dataclasses.is_dataclass(tp):
            return from_dict(tp, value)
        if issubclass(tp, enum.Enum):
            return tp(value)
        if tp is float and isinstance(value, int):
            return float(value)
    return value


def from_dict(cls: type[T], data: Optional[dict[str, Any]]) -> T:
    """Build dataclass ``cls`` from a camelCase dict, ignoring unknown keys.

    Missing keys — and keys explicitly set to JSON ``null``, which Kubernetes
    treats as unset — fall back to the field default; a field with no default
    becomes ``None`` (Kubernetes objects are pervasively partial, so we prefer
    permissiveness over hard failures at the deserialisation boundary).
    """
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise TypeError(f"expected dict for {cls.__name__}, got {type(data).__name__}")
    hints = _type_hints(cls)
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        key = f.metadata.get("wire_name") or snake_to_camel(f.name)
        if key not in data:
            key = f.name  # tolerate snake_case input too
        has_default = (
            f.default is not dataclasses.MISSING or f.default_factory is not dataclasses.MISSING
        )
        if data.get(key) is not None:
            kwargs[f.name] = _coerce(data[key], hints.get(f.name, Any))
        elif not has_default:
            kwargs[f.name] = None
    return cls(**kwargs)  # type: ignore[return-value]


def wire(name: str, **kw: Any) -> Any:
    """Field helper for attributes whose wire name isn't the camelCase of the
    python name (e.g. ``type_`` -> ``type``)."""
    metadata = dict(kw.pop("metadata", {}) or {})
    metadata["wire_name"] = name
    return dataclasses.field(metadata=metadata, **kw)
