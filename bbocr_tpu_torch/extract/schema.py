"""The book-metadata JSON contract.

Counterpart of ``bbocr_tpu/extract/schema.py``, with a small checker for
``METADATA_SCHEMA`` in place of ``jsonschema.validate``: it covers what the
schema uses (``type`` with type lists, ``properties`` and array ``items``;
properties are optional and extra keys are allowed, as in JSON Schema).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

METADATA_SCHEMA: Dict[str, Any] = {
    "type": "object",
    "properties": {
        "title": {"type": ["string", "null"]},
        "subtitle": {"type": ["string", "null"]},
        "authors": {"type": "array", "items": {"type": "string"}},
        "publisher": {"type": ["string", "null"]},
        "year": {"type": ["string", "null"]},
        "isbn_10": {"type": ["string", "null"]},
        "isbn_13": {"type": ["string", "null"]},
        "asin": {"type": ["string", "null"]},
        "edition": {"type": ["string", "null"]},
        "binding_type": {"type": ["string", "null"]},
        "language": {"type": ["string", "null"]},
        "page_count": {"type": ["integer", "null"]},
        "categories": {"type": "array", "items": {"type": "string"}},
        "description": {"type": ["string", "null"]},
        "condition_keywords": {"type": "array", "items": {"type": "string"}},
        "price": {
            "type": ["object", "null"],
            "properties": {
                "currency": {"type": ["string", "null"]},
                "amount": {"type": ["number", "null"]},
            },
        },
    },
}

_FIELDS_NULL = (
    "title", "subtitle", "publisher", "year", "isbn_10", "isbn_13",
    "asin", "edition", "binding_type", "language", "page_count",
    "description",
)

_ORDER = (
    "title", "subtitle", "authors", "publisher", "year", "isbn_10",
    "isbn_13", "asin", "edition", "binding_type", "language",
    "page_count", "categories", "description", "condition_keywords",
    "price",
)


class SchemaError(ValueError):
    """The metadata breaks ``METADATA_SCHEMA``."""


def empty_metadata() -> Dict[str, Any]:
    """All-null metadata skeleton, keys in the schema's order."""
    meta: Dict[str, Any] = {k: None for k in _FIELDS_NULL}
    meta["authors"] = []
    meta["categories"] = []
    meta["condition_keywords"] = []
    meta["price"] = {"currency": None, "amount": None}
    return {k: meta[k] for k in _ORDER}


def _is_type(value: Any, name: str) -> bool:
    if name == "null":
        return value is None
    if name == "string":
        return isinstance(value, str)
    if name == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if name == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if name == "array":
        return isinstance(value, list)
    if name == "object":
        return isinstance(value, dict)
    raise ValueError(f"schema type {name!r} is not supported")


def _check(value: Any, schema: Dict[str, Any], path: str) -> None:
    types = schema.get("type")
    if types is not None:
        names = [types] if isinstance(types, str) else list(types)
        if not any(_is_type(value, n) for n in names):
            # the first line is jsonschema's message for the same error
            raise SchemaError(
                f"{value!r} is not of type {', '.join(repr(n) for n in names)}\n\nOn instance{path}:\n    {value!r}"
            )
    if isinstance(value, dict):
        for key, sub in schema.get("properties", {}).items():
            if key in value:
                _check(value[key], sub, f"{path}[{key!r}]")
    if isinstance(value, list) and "items" in schema:
        for i, item in enumerate(value):
            _check(item, schema["items"], f"{path}[{i}]")


def validate_schema(metadata: Dict[str, Any]) -> None:
    """Raises :class:`SchemaError` on contract violations."""
    _check(metadata, METADATA_SCHEMA, "")


def validate_metadata(metadata: Dict[str, Any]) -> Tuple[bool, List[str]]:
    """Sanity rules: title required; ISBN-10/13 digit lengths when present."""
    issues: List[str] = []
    if not metadata.get("title"):
        issues.append("Missing title")
    isbn_10 = metadata.get("isbn_10")
    if isbn_10 and len(str(isbn_10).replace("-", "").replace(" ", "")) != 10:
        issues.append("ISBN-10 should be 10 characters")
    isbn_13 = metadata.get("isbn_13")
    if isbn_13 and len(str(isbn_13).replace("-", "").replace(" ", "")) != 13:
        issues.append("ISBN-13 should be 13 characters")
    return (len(issues) == 0, issues)
