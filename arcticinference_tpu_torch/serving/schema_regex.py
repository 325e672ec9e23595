"""JSON-schema → regex compiler for grammar-guided decoding.

The port's copy of ``arcticinference_tpu/serving/schema_regex.py`` (the
standard library only).

The reference delegates schema-constrained generation to vLLM's guided
decoding backends (outlines/xgrammar); here the same capability is
engine-native.  A schema is compiled to a single regex whose language is
exactly the set of conforming JSON documents (for the supported keyword
subset), then enforced per token through ``regex`` partial matching —
the decoder only ever commits tokens that keep the document extendable
to a conforming one, so conformance is *guaranteed*, not checked
post-hoc.

Supported keywords: ``type`` (all seven, incl. lists), ``enum``,
``const``, ``properties``/``required`` (properties emitted in
declaration order; optional properties may be omitted),
``items``/``prefixItems``/``minItems``/``maxItems``, ``minLength``/
``maxLength``/``pattern`` for strings, ``anyOf``/``oneOf``/``allOf``
(single-element), ``$ref`` into ``$defs``/``definitions`` (expanded to
a bounded depth).  Anything else raises :class:`UnsupportedSchema` and
the caller falls back to syntactic-JSON guidance + post-hoc validation
(the pre-existing behavior).

Reference parity: vLLM ``GuidedDecodingParams(json=schema)``; the
reference benchmarks this path in
``tests/benchmarks/test_benchmarks.py:46-76`` (test_json_mode).
"""

from __future__ import annotations

import json
import re as _stdre
from typing import Any

# Bounded inter-token whitespace (outlines-style): keeps the compiled
# regex small and partial matching fast while still accepting the
# formatting models actually emit.
WS = r"[ \n\t]{0,4}"

_STR_CHAR = r'(?:[^"\\\x00-\x1f]|\\(?:["\\/bfnrt]|u[0-9a-fA-F]{4}))'

_INTEGER = r"-?(?:0|[1-9][0-9]*)"
_NUMBER = r"-?(?:0|[1-9][0-9]*)(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?"
_BOOLEAN = r"(?:true|false)"
_NULL = r"null"

_MAX_REF_DEPTH = 8
_ANY_VALUE_DEPTH = 3


class UnsupportedSchema(ValueError):
    """Schema uses a keyword outside the compilable subset."""


def _lit(value: Any) -> str:
    """Regex matching the canonical JSON encoding of a constant."""
    return _stdre.escape(json.dumps(value, ensure_ascii=False))


def _string(schema: dict) -> str:
    if "pattern" in schema:
        # The pattern constrains the string *content*; anchors would be
        # meaningless inside the quoted body.
        pat = schema["pattern"]
        if pat.startswith("^"):
            pat = pat[1:]
        if pat.endswith("$") and not pat.endswith(r"\$"):
            pat = pat[:-1]
        return f'"(?:{pat})"'
    lo = schema.get("minLength", 0)
    hi = schema.get("maxLength")
    if hi is None:
        rep = f"{{{lo},}}" if lo else "*"
    else:
        rep = f"{{{lo},{hi}}}"
    return f'"{_STR_CHAR}{rep}"'


def _array(schema: dict, defs: dict, depth: int) -> str:
    prefix = schema.get("prefixItems")
    if prefix:
        head = f"{WS},{WS}".join(
            _value(s, defs, depth) for s in prefix)
        return rf"\[{WS}{head}{WS}\]"
    item = _value(schema.get("items", {}), defs, depth)
    lo = int(schema.get("minItems", 0))
    hi = schema.get("maxItems")
    if hi is not None and int(hi) < lo:
        raise UnsupportedSchema("maxItems < minItems")
    tail = f"(?:{WS},{WS}{item})"
    if hi is None:
        rep = f"{tail}{{{max(lo - 1, 0)},}}" if lo > 1 else f"{tail}*"
    else:
        hi = int(hi)
        if hi == 0:
            return rf"\[{WS}\]"
        rep = f"{tail}{{{max(lo - 1, 0)},{hi - 1}}}"
    body = f"{item}{rep}"
    if lo == 0:
        return rf"\[{WS}(?:{body}{WS})?\]"
    return rf"\[{WS}{body}{WS}\]"


def _object(schema: dict, defs: dict, depth: int) -> str:
    props: dict = schema.get("properties") or {}
    required = schema.get("required")
    req = set(required) if required is not None else set(props)
    unknown = req - set(props)
    if unknown:
        # A required name with no property schema can't be compiled into
        # the grammar — and silently dropping it would break the
        # conformance guarantee.
        raise UnsupportedSchema(f"required names outside properties: "
                                f"{sorted(unknown)}")
    if not props:
        if schema.get("additionalProperties") is False:
            return rf"\{{{WS}\}}"
        # Free-form object: bounded-depth generic members.
        member = f'"{_STR_CHAR}*"{WS}:{WS}{_any_value(depth - 1)}'
        return (rf"\{{{WS}(?:{member}(?:{WS},{WS}{member})*{WS})?\}}")

    pieces = []
    for name, sub in props.items():
        pieces.append((name in req,
                       f"{_lit(name)}{WS}:{WS}{_value(sub, defs, depth)}"))

    # Ordered-subset construction: properties appear in declaration
    # order; every required one is present, optional ones may be
    # skipped.  After the first emitted member the rest is linear
    # (comma-prefixed, optional members in (?:...)?); the first emitted
    # member is an alternation over candidates up to (and including)
    # the first required property.
    def tail(i: int) -> str:
        out = []
        for is_req, piece in pieces[i:]:
            seg = f"{WS},{WS}{piece}"
            out.append(seg if is_req else f"(?:{seg})?")
        return "".join(out)

    first_req = next((i for i, (r, _) in enumerate(pieces) if r),
                     len(pieces))
    alts = []
    for j in range(min(first_req, len(pieces) - 1) + 1):
        alts.append(f"{pieces[j][1]}{tail(j + 1)}")
    body = "|".join(alts)
    if first_req == len(pieces):     # everything optional: empty object ok
        return rf"\{{{WS}(?:(?:{body}){WS})?\}}"
    return rf"\{{{WS}(?:{body}){WS}\}}"


def _any_value(depth: int) -> str:
    """Generic JSON value, nesting bounded at `depth`."""
    scalar = f'(?:"{_STR_CHAR}*"|{_NUMBER}|{_BOOLEAN}|{_NULL})'
    if depth <= 0:
        return scalar
    inner = _any_value(depth - 1)
    arr = rf"\[{WS}(?:{inner}(?:{WS},{WS}{inner})*{WS})?\]"
    member = f'"{_STR_CHAR}*"{WS}:{WS}{inner}'
    obj = rf"\{{{WS}(?:{member}(?:{WS},{WS}{member})*{WS})?\}}"
    return f"(?:{scalar}|{arr}|{obj})"


def _resolve_ref(ref: str, defs: dict) -> dict:
    for prefix in ("#/$defs/", "#/definitions/"):
        if ref.startswith(prefix):
            name = ref[len(prefix):]
            if name in defs:
                return defs[name]
    raise UnsupportedSchema(f"unresolvable $ref {ref!r}")


_TYPE_DISPATCH = {
    "integer": lambda s, d, k: _INTEGER,
    "number": lambda s, d, k: _NUMBER,
    "boolean": lambda s, d, k: _BOOLEAN,
    "null": lambda s, d, k: _NULL,
    "string": lambda s, d, k: _string(s),
    "array": _array,
    "object": _object,
}


def _value(schema: Any, defs: dict, depth: int) -> str:
    if schema is True or schema == {}:
        return _any_value(_ANY_VALUE_DEPTH)
    if not isinstance(schema, dict):
        raise UnsupportedSchema(f"schema must be dict/True, got {schema!r}")
    if depth <= 0:
        raise UnsupportedSchema("$ref/nesting expansion too deep")

    if "$ref" in schema:
        return _value(_resolve_ref(schema["$ref"], defs), defs, depth - 1)
    if "const" in schema:
        return _lit(schema["const"])
    if "enum" in schema:
        opts = "|".join(_lit(v) for v in schema["enum"])
        return f"(?:{opts})"
    for comb in ("anyOf", "oneOf"):
        if comb in schema:
            opts = "|".join(_value(s, defs, depth - 1)
                            for s in schema[comb])
            return f"(?:{opts})"
    if "allOf" in schema:
        subs = schema["allOf"]
        if len(subs) != 1:
            raise UnsupportedSchema("allOf with >1 subschema")
        return _value(subs[0], defs, depth - 1)

    t = schema.get("type")
    if t is None:
        if "properties" in schema or "required" in schema:
            t = "object"
        elif any(k in schema for k in
                 ("items", "prefixItems", "minItems", "maxItems")):
            t = "array"
        else:
            return _any_value(_ANY_VALUE_DEPTH)
    if isinstance(t, list):
        opts = "|".join(_value({**schema, "type": one}, defs, depth)
                        for one in t)
        return f"(?:{opts})"
    fn = _TYPE_DISPATCH.get(t)
    if fn is None:
        raise UnsupportedSchema(f"unsupported type {t!r}")
    return fn(schema, defs, depth)


def schema_to_regex(schema: dict) -> str:
    """Compile a JSON schema to a full-document regex.

    Raises :class:`UnsupportedSchema` when the schema falls outside the
    supported subset — callers should fall back to unconstrained-JSON
    guidance with post-hoc validation.
    """
    if not isinstance(schema, dict):
        raise UnsupportedSchema("root schema must be an object")
    defs = {}
    defs.update(schema.get("definitions") or {})
    defs.update(schema.get("$defs") or {})
    return _value(schema, defs, _MAX_REF_DEPTH)
