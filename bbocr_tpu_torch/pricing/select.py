"""Best-offer selection + metadata merge.

The reference keeps this business logic in the pricing SPA's JavaScript
(``pipeline_demo/pricing_api/static/script.js:188-276`` — SURVEY.md §2.7
"business logic lives in the browser"). Here it is a server-side library so
the API, CLI, and frontend share one implementation; the frontend calls it
through the scanner service.

Selection ladder (first match wins):
1. strict year filter (when the scanned metadata has a year);
2. exact ISBN-13/10 match;
3. exact normalized title match;
4. fuzzy title match (stopword-stripped Jaccard >= 0.5);
5. cheapest offer with a numeric amount.

Merge: fill null scanned fields from the best offer; price is only set at
the pricing step (never from the scan).

Copied from ``bbocr_tpu/pricing/select.py`` (pure Python).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from bbocr_tpu_torch.pricing.parse import extract_year, norm_text

_STOPWORDS = {"a", "an", "the", "of", "and", "or", "in", "on", "for", "to", "with"}


def _title_tokens(title: Optional[str]) -> set:
    toks = re.findall(r"[a-z0-9]+", norm_text(title))
    return {t for t in toks if t not in _STOPWORDS}


def fuzzy_title_match(a: Optional[str], b: Optional[str], threshold: float = 0.5) -> bool:
    ta, tb = _title_tokens(a), _title_tokens(b)
    if not ta or not tb:
        return False
    jaccard = len(ta & tb) / len(ta | tb)
    return jaccard >= threshold


def select_best_offer(
    metadata: Dict[str, Any], offers: List[Dict[str, Any]]
) -> Tuple[Optional[Dict[str, Any]], str]:
    """Returns (best_offer | None, selection_reason)."""
    if not offers:
        return None, "no_offers"

    candidates = list(offers)
    year = extract_year(str(metadata.get("year") or metadata.get("publication_date") or ""))
    if year:
        year_matched = [
            o for o in candidates if extract_year(o.get("publication_date") or "") == year
        ]
        if year_matched:
            candidates = year_matched

    isbn_13 = (metadata.get("isbn_13") or "").replace("-", "")
    isbn_10 = (metadata.get("isbn_10") or "").replace("-", "")
    if isbn_13 or isbn_10:
        for o in candidates:
            o13 = (o.get("isbn_13") or "").replace("-", "")
            o10 = (o.get("isbn_10") or "").replace("-", "")
            if (isbn_13 and o13 == isbn_13) or (isbn_10 and o10 == isbn_10):
                return o, "isbn_exact"

    title = metadata.get("title")
    if title:
        q = norm_text(title)
        for o in candidates:
            if norm_text(o.get("title")) == q:
                return o, "title_exact"
        for o in candidates:
            if fuzzy_title_match(title, o.get("title")):
                return o, "title_fuzzy"

    priced = [o for o in candidates if isinstance(o.get("amount"), (int, float))]
    if priced:
        return min(priced, key=lambda o: o["amount"]), "cheapest"
    return candidates[0], "first_available"


_MERGE_FIELDS = (
    "title", "subtitle", "publisher", "year", "isbn_10", "isbn_13",
    "edition", "binding_type", "language", "page_count", "description",
)


def merge_offer_into_metadata(
    metadata: Dict[str, Any], offer: Optional[Dict[str, Any]]
) -> Dict[str, Any]:
    """Fill nulls in the scanned metadata from the chosen offer; attach
    price/currency and provenance fields (reference ``script.js:236-271``)."""
    merged = dict(metadata)
    if offer is None:
        return merged
    for field in _MERGE_FIELDS:
        if merged.get(field) in (None, "", []):
            src = offer.get(field)
            if field == "year" and not src:
                src = extract_year(offer.get("publication_date") or "")
            if src not in (None, "", []):
                merged[field] = src
    if not merged.get("authors") and offer.get("authors"):
        merged["authors"] = list(offer["authors"])
    if isinstance(offer.get("amount"), (int, float)):
        merged["price"] = {
            "currency": offer.get("currency"),
            "amount": offer.get("amount"),
        }
    merged["info_url"] = offer.get("url")
    merged["source_provider"] = offer.get("provider")
    return merged
