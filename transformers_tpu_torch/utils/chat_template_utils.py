"""Tool-use JSON schemas from Python functions.

Port of ``transformers_tpu/utils/chat_template_utils.py`` (reference
src/transformers/utils/chat_template_utils.py)
``get_json_schema`` — converts a function's signature + Google-style
docstring into the {"type": "function", "function": {...}} schema chat
templates render for tool calling. Supported: basic types, Optional/Union,
List/Dict/Tuple generics (incl. fixed-length tuples), Literal-free
``(choices: [...])`` docstring enums, nullable via Optional, and a
``Returns:`` block (emitted only when the docstring documents it).
"""

from __future__ import annotations

import inspect
import json
import re
import types
import typing
from typing import Any, Callable, Optional, Union, get_args, get_origin, get_type_hints


class TypeHintParsingException(Exception):
    """Raised when a type hint cannot be converted to a JSON schema."""


class DocstringParsingException(Exception):
    """Raised when a docstring is missing or malformed for schema extraction."""


_BASE_TYPES = {
    int: {"type": "integer"},
    float: {"type": "number"},
    str: {"type": "string"},
    bool: {"type": "boolean"},
    types.NoneType: {"type": "null"},
    Any: {},
}

# Google-style docstring sections (reference regexes, behaviorally)
_ARGS_SPLIT_RE = re.compile(r"\n\s*Args:\s*\n")
_RETURNS_SPLIT_RE = re.compile(r"\n\s*(?:Returns|Raises):\s*\n")
_ARG_LINE_RE = re.compile(
    r"^\s*(\w+)\s*(?:\([^)]*\))?\s*:\s*(.*?)(?=^\s*\w+\s*(?:\([^)]*\))?\s*:|\Z)",
    re.MULTILINE | re.DOTALL,
)
_ENUM_RE = re.compile(r"\(choices:\s*(.+?)\)\s*$", re.DOTALL)


def _parse_type_hint(hint) -> dict:
    origin = get_origin(hint)
    if origin is None:
        if hint in _BASE_TYPES:
            return dict(_BASE_TYPES[hint])
        raise TypeHintParsingException(f"Cannot convert type hint {hint!r} to a JSON schema")
    if origin is Union or origin is types.UnionType:
        args = get_args(hint)
        nullable = types.NoneType in args
        subtypes = [_parse_type_hint(a) for a in args if a is not types.NoneType]
        if len(subtypes) == 1:
            schema = subtypes[0]
        elif all(set(s) == {"type"} for s in subtypes):
            schema = {"type": sorted(s["type"] for s in subtypes)}
        else:
            schema = {"anyOf": subtypes}
        if nullable:
            schema["nullable"] = True
        return schema
    if origin in (list, typing.List):
        args = get_args(hint)
        if not args:
            return {"type": "array"}
        return {"type": "array", "items": _parse_type_hint(args[0])}
    if origin in (tuple, typing.Tuple):
        args = get_args(hint)
        if not args:
            return {"type": "array"}
        if len(args) == 2 and args[1] is Ellipsis:
            return {"type": "array", "items": _parse_type_hint(args[0])}
        return {
            "type": "array",
            "prefixItems": [_parse_type_hint(a) for a in args],
            "minItems": len(args),
            "maxItems": len(args),
        }
    if origin in (dict, typing.Dict):
        args = get_args(hint)
        schema = {"type": "object"}
        if args and len(args) == 2:
            schema["additionalProperties"] = _parse_type_hint(args[1])
        return schema
    raise TypeHintParsingException(f"Cannot convert type hint {hint!r} to a JSON schema")


def parse_google_format_docstring(docstring: str) -> tuple[Optional[str], dict, Optional[str]]:
    """(description, {arg: doc}, returns_doc) from a Google-style docstring."""
    parts = _ARGS_SPLIT_RE.split(docstring, maxsplit=1)
    description = parts[0].strip() or None
    args_doc: dict[str, str] = {}
    returns_doc = None
    if len(parts) > 1:
        rest = parts[1]
        tail = _RETURNS_SPLIT_RE.split(rest, maxsplit=1)
        args_block = tail[0]
        if len(tail) > 1:
            returns_doc = " ".join(tail[1].strip().split()) or None
        for m in _ARG_LINE_RE.finditer(args_block):
            args_doc[m.group(1)] = " ".join(m.group(2).strip().split())
    else:
        tail = _RETURNS_SPLIT_RE.split(docstring, maxsplit=1)
        if len(tail) > 1:
            description = tail[0].strip() or None
            returns_doc = " ".join(tail[1].strip().split()) or None
    return description, args_doc, returns_doc


def get_json_schema(func: Callable) -> dict:
    """reference utils/chat_template_utils.py ``get_json_schema``: signature +
    docstring -> tool schema. Raises DocstringParsingException when the
    docstring is absent or an argument is undocumented, and
    TypeHintParsingException for unsupported/missing hints."""
    doc = inspect.getdoc(func)
    if not doc:
        raise DocstringParsingException(
            f"Cannot generate JSON schema for {func.__name__} because it has no docstring!")
    description, args_doc, returns_doc = parse_google_format_docstring(doc)

    hints = get_type_hints(func)
    signature = inspect.signature(func)
    properties = {}
    required = []
    for name, param in signature.parameters.items():
        if name in ("self", "cls"):
            continue
        if name not in hints:
            raise TypeHintParsingException(
                f"Argument {name} of {func.__name__} has no type hint!")
        if name not in args_doc:
            raise DocstringParsingException(
                f"Argument {name} of {func.__name__} is not documented in the docstring!")
        schema = _parse_type_hint(hints[name])
        arg_desc = args_doc[name]
        enum_match = _ENUM_RE.search(arg_desc)
        if enum_match:
            try:
                schema["enum"] = json.loads("[" + enum_match.group(1).strip(" []") + "]")
            except json.JSONDecodeError as exc:
                raise DocstringParsingException(
                    f"Cannot parse choices for argument {name}: {enum_match.group(1)!r}") from exc
            arg_desc = _ENUM_RE.sub("", arg_desc).strip()
        schema["description"] = arg_desc
        properties[name] = schema
        if param.default is inspect.Parameter.empty:
            required.append(name)

    fn_schema: dict[str, Any] = {
        "name": func.__name__,
        "description": description or "",
        "parameters": {"type": "object", "properties": properties, "required": required},
    }
    if "return" in hints and returns_doc is not None:
        ret = _parse_type_hint(hints["return"])
        ret["description"] = returns_doc
        fn_schema["return"] = ret
    return {"type": "function", "function": fn_schema}
