"""Shared parsing utilities for pricing providers: multi-locale prices,
years, normalization. Behavior mirrors the reference's parsers
(``pipeline_demo/pricing_api/pricing_api/providers/abebooks_html.py:8-91``):
decimal separator inferred as the last of ',' '.', symbol and ISO-code
currency detection, first 18xx-20xx year.

Copied from ``bbocr_tpu/pricing/parse.py`` (pure Python)."""

from __future__ import annotations

import re
from typing import Optional, Tuple

_SYMBOL_CCY = {"$": "USD", "£": "GBP", "€": "EUR"}
_WORD_CCY = {
    "USD": "USD", "US$": "USD", "US DOLLARS": "USD",
    "GBP": "GBP", "EUR": "EUR", "CAD": "CAD", "AUD": "AUD",
    "C$": "CAD", "CA$": "CAD", "AU$": "AUD",
}

_PRICE_PATTERNS = (
    r"\b(USD|GBP|EUR|CAD|AUD)\b\s*([0-9][0-9.,]*)",
    r"(US\$|C\$|CA\$|AU\$)\s*([0-9][0-9.,]*)",
    r"([\$£€])\s*([0-9][0-9.,]*)",
    r"([0-9][0-9.,]*)\s*\b(USD|GBP|EUR|CAD|AUD)\b",
)


def norm_text(s: Optional[str]) -> str:
    if not s:
        return ""
    return re.sub(r"\s+", " ", s).strip().lower()


def extract_year(text: Optional[str]) -> Optional[str]:
    m = re.search(r"(18|19|20)\d{2}", text or "")
    return m.group(0) if m else None


def parse_amount(num_str: Optional[str]) -> Optional[float]:
    """'1.234,56' -> 1234.56; '1,234.56' -> 1234.56; '12' -> 12.0."""
    if not num_str:
        return None
    s = str(num_str).strip()
    last_comma, last_dot = s.rfind(","), s.rfind(".")
    if last_comma == -1 and last_dot == -1:
        try:
            return float(s)
        except ValueError:
            return None
    dec, thou = (",", ".") if last_comma > last_dot else (".", ",")
    s = s.replace(thou, "").replace(dec, ".")
    try:
        return float(s)
    except ValueError:
        return None


def parse_price(text: Optional[str]) -> Tuple[Optional[str], Optional[float]]:
    """Free text -> (currency, amount)."""
    if not text:
        return None, None
    t = re.sub(r"\s+", " ", str(text)).strip()
    for pat in _PRICE_PATTERNS:
        m = re.search(pat, t, flags=re.IGNORECASE)
        if not m:
            continue
        g1, g2 = m.group(1), m.group(2)
        if g1 in _SYMBOL_CCY:
            return _SYMBOL_CCY[g1], parse_amount(g2)
        up1, up2 = g1.upper(), g2.upper()
        if up2 in _WORD_CCY:
            return _WORD_CCY[up2], parse_amount(g1)
        if up1 in _WORD_CCY:
            return _WORD_CCY[up1], parse_amount(g2)
    m = re.search(r"(US\$|C\$|CA\$|AU\$)([0-9][0-9.,]*)", t, flags=re.IGNORECASE)
    if m:
        return _WORD_CCY.get(m.group(1).upper()), parse_amount(m.group(2))
    return None, None


def make_offer(
    provider: str,
    *,
    listing_id: Optional[str] = None,
    title: Optional[str] = None,
    authors: Optional[list] = None,
    publisher: Optional[str] = None,
    publication_date: Optional[str] = None,
    isbn_13: Optional[str] = None,
    isbn_10: Optional[str] = None,
    currency: Optional[str] = None,
    amount: Optional[float] = None,
    url: Optional[str] = None,
    source: str = "metadata",
) -> dict:
    """The offer dict contract every provider returns
    (reference ``providers/google_books.py:47-64``)."""
    return {
        "provider": provider,
        "listing_id": listing_id,
        "title": title,
        "authors": authors or [],
        "publisher": publisher,
        "publication_date": publication_date,
        "isbn_13": isbn_13,
        "isbn_10": isbn_10,
        "currency": currency,
        "amount": amount,
        "url": url,
        "source": source,
    }
