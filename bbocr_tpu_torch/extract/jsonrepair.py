"""LLM response -> JSON repair + parse.

Counterpart of ``bbocr_tpu/extract/jsonrepair.py``: strip markdown fences,
slice the outermost brace span, null out the prompt's template
placeholders, parse. Raises ``json.JSONDecodeError`` when unparseable
(callers build the all-null fallback).
"""

from __future__ import annotations

import json
from typing import Any, Dict

# Placeholder strings from the prompt's OUTPUT block that weak models echo
# back verbatim; each maps to a JSON null/empty value.
_PLACEHOLDER_NULLS = (
    '"string | null"',
    '"integer | null"',
    '"float | null"',
    '"YYYY | null"',
)
_PLACEHOLDER_EMPTY_LIST = '["string", "..."] | []'


def repair_and_parse(response_text: str) -> Dict[str, Any]:
    text = response_text.replace("```json", "").replace("```", "")
    start = text.find("{")
    end = text.rfind("}")
    if start >= 0 and end >= 0:
        text = text[start : end + 1]
        for ph in _PLACEHOLDER_NULLS:
            text = text.replace(ph, "null")
        text = text.replace(_PLACEHOLDER_EMPTY_LIST, "[]")
    return json.loads(text)
