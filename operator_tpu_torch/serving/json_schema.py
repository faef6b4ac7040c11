"""JSON Schema -> regex, for schema-constrained decoding (guided_json).

Port of ``operator_tpu/serving/json_schema.py`` (plain Python, copied as
it is).  The serving stack constrains decoding with token-level automata compiled
from byte-level regexes (serving/regex_dfa.py).  A JSON *Schema* with
fixed structure describes a REGULAR language — every production is
finite: objects list their properties, arrays bound their lengths, and
scalars are regular — so a schema lowers to one regex and rides the
existing guided_regex machinery end to end (DFA -> token table -> decode
block).  No new device code; ``guided_json`` is pure front-end sugar.

Supported schema subset (anything else raises ValueError at submit time,
never inside a co-batched wave):

- ``type: object`` with ``properties`` (at most 32) — emission order is
  required properties (declaration order) then optional ones; ANY subset
  of the optional properties may appear.  With a required anchor each
  optional member independently carries its own comma; an all-optional
  object enumerates one chain per starting member, which is quadratic in
  the property count — hence the 32-property cap
- ``type: string`` (optionally ``enum``/``const``; ``maxLength`` up to 64
  — the regex engine's bounded-repeat cap — and unbounded when absent,
  including with a bare ``minLength``)
- ``type: integer`` / ``number`` (optionally ``enum``/``const``)
- ``type: boolean`` / ``null``
- ``enum`` / ``const`` of scalars at any position
- ``type: array`` with ``items``; ``minItems``/``maxItems`` <= 64, and
  unbounded length when ``maxItems`` is absent
- ``anyOf`` / ``oneOf`` -> alternation
- nesting of all of the above

Deliberately NOT supported: ``$ref``/``$defs`` (recursion is not
regular), ``additionalProperties: true`` (unbounded free-form keys),
``patternProperties``, unconstrained ``object``/``array`` without
``properties``/``items``, and bare ``{"type": "json_object"}``-style
free-form JSON (nested braces need a stack; a DFA has none).

Output is COMPACT canonical JSON — no whitespace between tokens — so the
automaton stays small and generated text parses with any JSON parser.
"""

from __future__ import annotations

import json
from typing import Any

from .regex_dfa import MAX_REPEAT as _MAX_BOUND  # bounded-repeat ceiling

#: hard budget for the lowered pattern (and, checked at every recursion
#: level, for any sub-pattern): construction doubles the item regex per
#: nesting level (seq + repeat tail), so an after-the-fact check would
#: let a ~2 KB deeply-nested schema build gigabyte strings first
_PATTERN_BUDGET = 16384

# JSON string body: any char except '"', '\' and control bytes, or an
# escape sequence.  Byte-level classes, so non-ASCII rides as UTF-8.
# regex_dfa rejects \xNN escapes, so the control range is embedded as RAW
# bytes (the class parser range-matches any single byte)
_STRING_CHAR = (
    '([^"\\\\\x00-\x1f]'      # plain char (class: " \ and 0x00-0x1f excluded)
    '|\\\\["\\\\/bfnrt]'      # two-char escape: \" \\ \/ \b \f \n \r \t
    '|\\\\u[0-9a-fA-F]{4})'   # \uXXXX
)
_STRING = f'"{_STRING_CHAR}*"'
# digit counts are CAPPED (16 ~ int64 range, exponent 3): an unbounded
# \d* lets a degenerate model extend a number to max_tokens and truncate
# the document mid-match; the cap is semantically invisible and keeps
# every numeric production finite
_INTEGER = r"-?(0|[1-9]\d{0,15})"
_NUMBER = r"-?(0|[1-9]\d{0,15})(\.\d{1,15})?([eE][+-]?\d{1,3})?"
_BOOLEAN = r"(true|false)"
_NULL = r"null"

_REGEX_SPECIALS = set(".^$*+?{}[]()|\\")


def _lit(text: str) -> str:
    """Regex-escape a literal string."""
    out = []
    for ch in text:
        if ch in _REGEX_SPECIALS:
            out.append("\\" + ch)
        else:
            out.append(ch)  # json.dumps already escaped control chars
    return "".join(out)


def _scalar_literal(value: Any) -> str:
    """The regex matching exactly one JSON scalar value."""
    if value is None or isinstance(value, (bool, int, float, str)):
        try:
            # allow_nan=False: json.dumps(inf) would emit the literal
            # "Infinity", forcing output no RFC 8259 parser accepts
            return _lit(json.dumps(value, allow_nan=False))
        except ValueError:
            raise ValueError(
                f"enum/const value {value!r} has no JSON representation"
            ) from None
    raise ValueError(
        f"enum/const values must be JSON scalars, got {type(value).__name__}"
    )


def _bound(schema: dict, key: str, default: int) -> int:
    value = schema.get(key, default)
    if not isinstance(value, int) or value < 0 or value > _MAX_BOUND:
        raise ValueError(
            f"{key}={value!r} unsupported (must be an int in [0, {_MAX_BOUND}] "
            f"— the automaton's bounded-repeat cap)"
        )
    return value


def _string_regex(schema: dict) -> str:
    if "minLength" in schema or "maxLength" in schema:
        lo = _bound(schema, "minLength", 0)
        if "maxLength" not in schema:
            # minLength alone must NOT silently impose a ceiling: emit the
            # unbounded {m,} repeat (same openness as the default _STRING)
            return f'"{_STRING_CHAR}{{{lo},}}"'
        hi = _bound(schema, "maxLength", _MAX_BOUND)
        if lo > hi:
            raise ValueError(f"minLength {lo} > maxLength {hi}")
        return f'"{_STRING_CHAR}{{{lo},{hi}}}"'
    return _STRING


def _object_regex(schema: dict) -> str:
    properties = schema.get("properties")
    if not isinstance(properties, dict) or not properties:
        raise ValueError(
            "type:object needs non-empty 'properties' (free-form objects "
            "are not a regular language)"
        )
    if schema.get("additionalProperties") not in (None, False):
        raise ValueError("additionalProperties must be false/absent")
    if len(properties) > 32:
        raise ValueError(
            f"object has {len(properties)} properties; at most 32 supported "
            f"(the all-optional construction is quadratic in property count)"
        )
    required = schema.get("required")
    if required is None:
        required_set = set(properties)
    else:
        if not isinstance(required, list) or not all(
            isinstance(n, str) for n in required
        ):
            raise ValueError("'required' must be a list of property names")
        unknown = set(required) - set(properties)
        if unknown:
            raise ValueError(f"required names unknown properties: {sorted(unknown)}")
        required_set = set(required)

    def member(name: str) -> str:
        return f"{_lit(json.dumps(name))}:{_schema_regex(properties[name])}"

    # emission order: required properties (declaration order) first, then
    # optional ones — with a required anchor present, every optional
    # member carries its own leading comma and any SUBSET may appear
    required_members = [member(n) for n in properties if n in required_set]
    optional_members = [member(n) for n in properties if n not in required_set]
    if required_members:
        body = ",".join(required_members) + "".join(
            f"(,{m})?" for m in optional_members
        )
    elif optional_members:
        # no required anchor: the first present member has no comma, so
        # enumerate each "starts at member i" chain (any subset, in order)
        chains = [
            optional_members[i]
            + "".join(f"(,{m})?" for m in optional_members[i + 1:])
            for i in range(len(optional_members))
        ]
        body = "(" + "|".join(chains) + ")?"
    else:  # unreachable: properties is non-empty
        body = ""
    return "\\{" + body + "\\}"


def _array_regex(schema: dict) -> str:
    items = schema.get("items")
    if not isinstance(items, dict):
        raise ValueError(
            "type:array needs an 'items' schema (free-form arrays are not "
            "a regular language)"
        )
    lo = _bound(schema, "minItems", 0)
    item = _schema_regex(items)
    if "maxItems" not in schema:
        # no ceiling given: unbounded {m,} tail, not a silent 64 cap
        more = f"(,{item}){{{max(0, lo - 1)},}}"
    else:
        hi = _bound(schema, "maxItems", _MAX_BOUND)
        if lo > hi:
            raise ValueError(f"minItems {lo} > maxItems {hi}")
        if hi == 0:
            return r"\[\]"
        # first item + up to hi-1 comma-separated others
        more = f"(,{item}){{{max(0, lo - 1)},{hi - 1}}}"
    seq = f"{item}{more}"
    if lo == 0:
        seq = f"({seq})?"
    return r"\[" + seq + r"\]"


def _schema_regex(schema: Any) -> str:
    """Recursive lowering with the pattern budget enforced at EVERY level:
    each nesting level embeds its child pattern up to twice, so checking
    only the final string would first materialise ~2^depth bytes."""
    regex = _schema_regex_impl(schema)
    if len(regex) > _PATTERN_BUDGET:
        raise ValueError(
            f"schema lowers to a pattern above the {_PATTERN_BUDGET}-char "
            f"budget — reduce optional properties, bounds, or nesting"
        )
    return regex


def _schema_regex_impl(schema: Any) -> str:
    if not isinstance(schema, dict):
        raise ValueError(f"schema must be an object, got {type(schema).__name__}")
    for key in ("$ref", "$defs", "definitions", "patternProperties"):
        if key in schema:
            raise ValueError(f"{key} is not supported (recursion is not regular)")
    if "const" in schema:
        return _scalar_literal(schema["const"])
    if "enum" in schema:
        values = schema["enum"]
        if not isinstance(values, list) or not values:
            raise ValueError("enum must be a non-empty list")
        return "(" + "|".join(_scalar_literal(v) for v in values) + ")"
    alts = schema.get("anyOf") or schema.get("oneOf")
    if alts is not None:
        if not isinstance(alts, list) or not alts:
            raise ValueError("anyOf/oneOf must be a non-empty list")
        return "(" + "|".join(_schema_regex(s) for s in alts) + ")"
    kind = schema.get("type")
    if isinstance(kind, list):
        if not kind:
            raise ValueError("type: [] is empty")
        return "(" + "|".join(
            _schema_regex({**schema, "type": k}) for k in kind
        ) + ")"
    if kind == "object":
        return _object_regex(schema)
    if kind == "array":
        return _array_regex(schema)
    if kind == "string":
        return _string_regex(schema)
    if kind == "integer":
        return _INTEGER
    if kind == "number":
        return _NUMBER
    if kind == "boolean":
        return _BOOLEAN
    if kind == "null":
        return _NULL
    raise ValueError(
        f"unsupported schema: type={kind!r} (supported: object/array/string/"
        f"integer/number/boolean/null, enum/const, anyOf/oneOf)"
    )


def schema_to_regex(schema: "dict | str") -> str:
    """Compile a JSON Schema (dict or JSON text) to a full-match regex.

    The result feeds ``guided_regex`` unchanged: regex_dfa compiles it to
    a DFA whose token-closure table the decode block consumes.
    """
    if isinstance(schema, str):
        try:
            schema = json.loads(schema)
        except json.JSONDecodeError as exc:
            raise ValueError(f"guided_json is not valid JSON: {exc}") from None
    # the budget is enforced at every recursion level (_schema_regex);
    # user-typed guided_regex is separately capped at 1024 chars by the
    # HTTP layer — schema-lowered patterns get this larger budget because
    # NFA + subset construction run at submit time on the serving thread
    return _schema_regex(schema)


#: input-size ceiling shared by every guided_json entry point
MAX_SCHEMA_BYTES = 8192


def lower_guided_json(schema: Any) -> str:
    """Validate + lower a user-supplied guided_json value to a regex.

    The ONE front door for both entry points — the HTTP API
    (serving/httpserver.py) and AIProvider ``additionalConfig``
    (serving/provider.py) — so input-shape checks and the schema-size cap
    can never drift between them.  Raises ValueError on anything
    unservable.
    """
    if not isinstance(schema, (dict, str)):
        raise ValueError("guided_json must be a schema object or JSON string")
    encoded = json.dumps(schema) if isinstance(schema, dict) else schema
    if len(encoded) > MAX_SCHEMA_BYTES:
        raise ValueError(
            f"guided_json schema too large (>{MAX_SCHEMA_BYTES} bytes)"
        )
    return schema_to_regex(schema)


__all__ = ["MAX_SCHEMA_BYTES", "lower_guided_json", "schema_to_regex"]
