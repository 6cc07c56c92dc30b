"""VLM prompt construction.

Functionally equivalent to the reference's prompt contract
(``pipeline_demo/extractor/prompts/enhanced_book_metadata_prompt.txt``):
strict JSON-only output, null-if-unseen, on-page-year-only rules, OCR
context weighting, and the exact OUTPUT placeholder block (whose literal
placeholder strings the JSON repair step depends on). The OCR-context
appendix format matches ``enhanced_extractor.py:563-586`` (pages numbered
from 2, since OCR defaults skip the cover).
"""

from __future__ import annotations

from typing import List, Optional

PROMPT_TEMPLATE = """You are a vision-language extraction system. From the supplied photos of a \
physical book (cover, title page, copyright/imprint page) produce structured \
metadata used for pricing and inventory. OCR text from the information pages \
may be appended below as extra context.

RULES:
- Output exactly one JSON object and nothing else: no commentary, no markdown.
- Any field you cannot read directly from the photos must be null.
- Never guess or infer a date. Only a four-digit year visible on-page counts.

CHOOSING THE YEAR:
- Look at the title page and its verso (the copyright/imprint page) first, \
preferring the imprint line of this printing.
- Multiple years usually mean copyright or registration dates; pick the year \
attached to the imprint/publisher line of THIS copy.
- OCR context may corroborate a year, but use it only when you can confirm it \
visually or it is unambiguous in the OCR text.
- No visible four-digit year means "year": null.

USING OCR CONTEXT:
- OCR lines come from the information pages (usually copyright/imprint).
- Treat OCR as support for hard-to-read print (publisher names, ISBNs); when \
OCR and the image disagree, the image wins — OCR can contain errors.

OUTPUT (strict JSON):
{
\t"title": "string | null",
\t"subtitle": "string | null",
\t"authors": ["string", "..."] | [],
\t"publisher": "string | null",
\t"year": "YYYY | null",
\t"isbn_10": "string | null",
\t"isbn_13": "string | null",
\t"asin": "string | null",
\t"edition": "string | null",
\t"binding_type": "string | null",
\t"language": "string | null",
\t"page_count": "integer | null",
\t"categories": ["string", "..."] | [],
\t"description": "string | null",
\t"condition_keywords": ["string", "..."] | [],
}"""


def build_prompt(ocr_texts: List[str], template: Optional[str] = None) -> str:
    """Prompt template + OCR-context appendix (reference format,
    ``enhanced_extractor.py:567-578``)."""
    template = template if template is not None else PROMPT_TEMPLATE
    ocr_context = ""
    if ocr_texts:
        ocr_context = "\n\nADDITIONAL OCR CONTEXT FROM INFORMATION PAGES:\n"
        for i, text in enumerate(ocr_texts, 1):
            if text.strip():
                ocr_context += f"\nPage {i + 1} OCR Text:\n{text.strip()}\n"
    return template + ocr_context
