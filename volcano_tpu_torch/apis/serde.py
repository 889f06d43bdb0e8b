"""Generic dataclass ↔ dict (de)serialization with k8s-style camelCase keys.

A copy of ``volcano_tpu/apis/serde.py``.

All API objects round-trip through plain dicts so the CLI can read/write YAML
and the in-memory API server can deep-copy objects cheaply.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import re
import typing

_CAMEL_RE = re.compile(r"(?<!^)(?=[A-Z])")


@functools.lru_cache(maxsize=4096)
def snake(name: str) -> str:
    return _CAMEL_RE.sub("_", name).lower()


@functools.lru_cache(maxsize=4096)
def camel(name: str) -> str:
    head, *tail = name.split("_")
    return head + "".join(p.capitalize() for p in tail)


#: cls → (resolved type hints, field-name set).  ``get_type_hints``
#: re-compiles every PEP-563 string annotation on every call — at one
#: call per from_dict it dominated the whole store (every clone(),
#: every bus frame, every commit) with ~0.8 ms of typing machinery per
#: object; the hints are immutable per class, so resolve once.
_CLASS_INFO: dict = {}


def _class_info(cls):
    cached = _CLASS_INFO.get(cls)
    if cached is None:
        hints = typing.get_type_hints(cls)
        names = frozenset(f.name for f in dataclasses.fields(cls))
        cached = (hints, names)
        _CLASS_INFO[cls] = cached
    return cached


def _unwrap_optional(tp):
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


#: values ``copy.deepcopy`` returns as they are
_IMMUTABLE = frozenset({str, int, float, bool, type(None)})


@functools.lru_cache(maxsize=None)
def _plan(tp):
    """How ``_from_value`` builds a value of annotation ``tp``: ("dc",
    cls), ("list", element type), ("dict", value type) or ("leaf",
    None) — the typing introspection, done once per annotation (the
    replicated store decodes every shipped object, and the per-value
    introspection was most of a decode)."""
    tp = _unwrap_optional(tp)
    origin = typing.get_origin(tp)
    if dataclasses.is_dataclass(tp):
        return "dc", tp
    if origin in (list, typing.List):
        (elem,) = typing.get_args(tp)
        return "list", elem
    if origin in (dict, typing.Dict):
        return "dict", typing.get_args(tp)[1]
    return "leaf", None


def _from_value(tp, value):
    if value is None:
        return None
    kind, arg = _plan(tp)
    if kind == "dc":
        return from_dict(arg, value)
    if kind == "list":
        return [_from_value(arg, v) for v in value]
    if kind == "dict":
        return {k: _from_value(arg, v) for k, v in value.items()}
    return value if type(value) in _IMMUTABLE else copy.deepcopy(value)


def from_dict(cls, data):
    """Build dataclass ``cls`` from a dict with camelCase or snake_case keys."""
    if data is None:
        return None
    if dataclasses.is_dataclass(data.__class__):
        return copy.deepcopy(data)
    hints, names = _class_info(cls)
    kwargs = {}
    for key, value in data.items():
        name = key if key in names else snake(key)
        if name not in names:
            continue
        kwargs[name] = _from_value(hints[name], value)
    return cls(**kwargs)


#: type → whether ``structural_copy`` rebuilds it field by field
_DATACLASS: dict = {}


def structural_copy(value):
    """A deep copy of an API object tree: a dataclass instance rebuilt
    from its ``__dict__``, lists and dicts copied element by element,
    immutable leaves shared, anything else through ``copy.deepcopy``.
    Equal to ``copy.deepcopy``'s for these trees (no reference cycles,
    no object reached twice) at a fifth of its cost: the store clones an
    object on every get, write and notification, and ``deepcopy``'s
    generic dispatch was most of a replicated commit frame's time."""
    tp = type(value)
    if tp in _IMMUTABLE:
        return value
    if tp is list:
        return [v if type(v) in _IMMUTABLE else structural_copy(v) for v in value]
    if tp is dict:
        return {k: (v if type(v) in _IMMUTABLE else structural_copy(v)) for k, v in value.items()}
    dc = _DATACLASS.get(tp)
    if dc is None:
        dc = _DATACLASS[tp] = dataclasses.is_dataclass(tp) and hasattr(tp, "__dict__")
    if dc:
        new = object.__new__(tp)
        fields = new.__dict__
        for k, v in value.__dict__.items():
            fields[k] = v if type(v) in _IMMUTABLE else structural_copy(v)
        return new
    return copy.deepcopy(value)


#: type → whether its instances encode as dataclasses
_ENCODES_AS_DATACLASS: dict = {}


def _to_value(value, drop_empty: bool):
    tp = type(value)
    if tp in _IMMUTABLE:
        return value
    dc = _ENCODES_AS_DATACLASS.get(tp)
    if dc is None:
        dc = _ENCODES_AS_DATACLASS[tp] = (dataclasses.is_dataclass(tp)
                                          and not issubclass(tp, type))
    if dc:
        return to_dict(value, drop_empty=drop_empty)
    if isinstance(value, list):
        return [_to_value(v, drop_empty) for v in value]
    if isinstance(value, dict):
        return {k: _to_value(v, drop_empty) for k, v in value.items()}
    return copy.deepcopy(value)


#: cls → ((field name, camelCase name), ...) — ``dataclasses.fields``
#: plus the camel conversion per call showed up on the bus fan-out
#: profile (every watch notify encodes old+new); both are immutable
#: per class.
_FIELD_NAMES: dict = {}


def _field_names(cls):
    cached = _FIELD_NAMES.get(cls)
    if cached is None:
        cached = tuple(
            (f.name, camel(f.name)) for f in dataclasses.fields(cls)
        )
        _FIELD_NAMES[cls] = cached
    return cached


def to_dict(obj, drop_empty: bool = True) -> dict:
    """Dataclass → dict with camelCase keys; empty/None fields dropped."""
    out = {}
    for name, camel_name in _field_names(obj.__class__):
        value = getattr(obj, name)
        if drop_empty and (value is None or value == [] or value == {}):
            continue
        out[camel_name] = _to_value(value, drop_empty)
    return out
