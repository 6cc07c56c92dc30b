"""AbeBooks live-HTML scrape provider.

Behavioral port of the reference scraper
(``pipeline_demo/pricing_api/pricing_api/providers/abebooks_html.py:94-312``):
keyword search (title + primary author + year) sorted by price ascending
with a browser UA, card parsing with layered selector fallbacks (srp
classes, microdata itemprops, add-to-basket data attributes, free-text
price/year regex), relevance scoring (exact/substring title, author
substring, year match), a STRICT year filter when the query carries a year,
and the top-10 by (score desc, amount desc tiebreak) — all errors per-card
isolated.

Parsing helpers live in ``bbocr_tpu_torch.pricing.parse``; the HTML traversal is
restructured around a single ``_parse_card`` function so recorded-HTML
contract tests can drive it directly (SURVEY.md §4 test strategy (c)).

Counterpart of ``bbocr_tpu/pricing/providers/abebooks_html.py``. The page
is parsed by ``_html.parse_html``, a tree built by bs4's ``html.parser``
rules from the standard library's parser, in place of BeautifulSoup, which
the port does not need. ``httpx`` is imported only when a lookup reaches
the network, inside ``_async_client``; without it that raises
``ImportError`` naming it, which the aggregator files under the provider's
error. Tests replace ``_async_client`` with a canned client.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, List, Optional

from bbocr_tpu_torch.pricing.parse import extract_year, make_offer, norm_text, parse_amount, parse_price
from bbocr_tpu_torch.pricing.providers._html import parse_html

LOGGER = logging.getLogger("bbocr_tpu_torch.pricing.abebooks")

BASE_URL = "https://www.abebooks.com/servlet/SearchResults"
_UA = (
    "Mozilla/5.0 (Windows NT 10.0; Win64; x64) AppleWebKit/537.36 "
    "(KHTML, like Gecko) Chrome/124.0 Safari/537.36"
)

_CARD_SELECTORS = (
    ".srp-list-item, .cf .result, .srp-item, .result, .cf.search-result, .search-result",
    "li.srp-list-item",
    "li, div",
)

_PRICE_SELECTORS = (
    "[itemprop='price']",
    "meta[itemprop='price']",
    ".item-price",
    ".srp-item-price",
    ".price",
    "[data-cy='listing-price']",
    "[data-cy='item-price']",
)


def _async_client(**kwargs):
    """``httpx.AsyncClient(**kwargs)``."""
    try:
        import httpx
    except ImportError as e:
        raise ImportError("the abebooks provider needs the httpx package") from e
    return httpx.AsyncClient(**kwargs)


def _parse_card(card) -> Optional[Dict[str, Any]]:
    """One result card -> offer dict (or None if it has no usable signal)."""
    title_el = card.select_one("h2.srp-title") or card.select_one(".srp-title")
    title = title_el.get_text(strip=True) if title_el else None
    if not title:
        link = card.select_one("a.srp-item-detail-link")
        if link:
            txt = link.get_text(" ", strip=True)
            if txt:
                title = txt.splitlines()[0].strip()
    if not title:
        h2 = card.find("h2")
        if h2:
            title = h2.get_text(strip=True) or None

    link = card.select_one("a.srp-item-detail-link") or card.select_one("a[href*='/bd']")
    href = link.get("href") if link else None
    if href and not href.startswith("http"):
        href = "https://www.abebooks.com" + href

    author_el = card.select_one(".author, .srp-author, .result-author, .text-muted")
    author = author_el.get_text(strip=True) if author_el else None

    currency = None
    amount = None
    price_text = None
    for sel in _PRICE_SELECTORS:
        el = card.select_one(sel)
        if el is None:
            continue
        if el.has_attr("content"):
            amount = parse_amount(el.get("content"))
            cur_el = card.select_one("meta[itemprop='priceCurrency']") or card.select_one(
                "[itemprop='priceCurrency']"
            )
            if cur_el is not None and cur_el.has_attr("content"):
                currency = (cur_el.get("content") or "").strip().upper() or None
        if amount is None:
            price_text = el.get_text(" ", strip=True)
        break
    if amount is None:
        ccy, amt = parse_price(price_text or card.get_text(" ", strip=True))
        currency = currency or ccy
        amount = amt
    if amount is None:
        basket = card.select_one("a[id^='add-to-basket-link-']")
        if basket is not None:
            raw = basket.get("data-csa-c-cost")
            if raw:
                try:
                    amount = float(raw)
                except ValueError:
                    pass
            cur_raw = (basket.get("data-csa-c-purchase-currency") or "").upper()
            if currency is None and ("US%24" in cur_raw or "USD" in cur_raw):
                currency = "USD"

    pub_date = None
    date_el = (
        card.select_one("meta[itemprop='datePublished']")
        or card.select_one("[itemprop='datePublished']")
        or card.select_one("time[itemprop='datePublished']")
        or card.select_one("time")
    )
    if date_el is not None:
        pub_date = (
            (date_el.get("content") or "").strip()
            if date_el.has_attr("content")
            else date_el.get_text(strip=True)
        ) or None
    if not pub_date:
        snippet = card.get_text(" ", strip=True)
        m = re.search(
            r"(?:Published|Publication\s*date|Publication)\s*[:\-]?\s*(?:[A-Za-z]+\s+)?((?:18|19|20)\d{2})",
            snippet,
            flags=re.IGNORECASE,
        )
        pub_date = m.group(1) if m else extract_year(snippet)

    if not title and not href and amount is None:
        return None
    return make_offer(
        "abebooks",
        listing_id=href,
        title=title,
        authors=[author] if author else [],
        publication_date=pub_date,
        currency=currency,
        amount=amount,
        url=href,
        source="scrape",
    )


def score_offer(offer: Dict[str, Any], q_title: str, q_author: str, q_year: Optional[str]) -> float:
    """Relevance score (reference ``score_offer``, ``abebooks_html.py:149-161``)."""
    s = 0.0
    o_title = norm_text(offer.get("title"))
    if q_title and o_title == q_title:
        s += 3.0
    elif q_title and q_title in o_title:
        s += 1.5
    authors = offer.get("authors") or [None]
    if q_author and q_author in norm_text(authors[0] or ""):
        s += 1.5
    if q_year and offer.get("publication_date"):
        if extract_year(offer["publication_date"]) == q_year:
            s += 1.0
    return s


def parse_results_html(
    html: str,
    *,
    title: Optional[str],
    primary_author: Optional[str],
    year: Optional[str],
    limit: int = 10,
) -> List[Dict[str, Any]]:
    """Full page -> scored/filtered/sorted offers (pure, test-drivable)."""
    soup = parse_html(html)
    cards = []
    for sel in _CARD_SELECTORS:
        cards = soup.select(sel)
        if cards:
            break

    q_title = norm_text(title)
    q_author = norm_text(primary_author)
    offers: List[Dict[str, Any]] = []
    seen = set()
    for card in cards:
        try:
            offer = _parse_card(card)
        except Exception:
            continue
        if offer is None:
            continue
        key = (offer["url"], offer["title"], offer["amount"])
        if key in seen:
            continue
        seen.add(key)
        offer["score"] = score_offer(offer, q_title, q_author, year)
        offers.append(offer)

    if year:
        offers = [o for o in offers if extract_year(o.get("publication_date") or "") == year]

    offers.sort(key=lambda o: (o.get("score", 0.0), -(o.get("amount") or 0)), reverse=True)
    return offers[:limit]


class AbeBooksHtmlProvider:
    async def lookup(
        self,
        *,
        title: Optional[str],
        authors: List[str],
        isbn_13: Optional[str],
        isbn_10: Optional[str],
        publisher: Optional[str],
        publication_date: Optional[str],
    ) -> List[Dict[str, Any]]:
        primary_author = authors[0] if authors else None
        year = extract_year(publication_date or "")
        keywords = " ".join(p for p in (title, primary_author, year) if p)
        if not keywords:
            return []

        params = {"kn": keywords, "sortby": "17"}  # 17 = price ascending
        headers = {"User-Agent": _UA, "Accept-Language": "en-US,en;q=0.9"}
        async with _async_client(timeout=8.0, headers=headers) as client:
            resp = await client.get(BASE_URL, params=params)
            resp.raise_for_status()
            html = resp.text

        offers = parse_results_html(
            html, title=title, primary_author=primary_author, year=year
        )
        LOGGER.info("abebooks: keywords=%r year=%r offers=%d", keywords, year, len(offers))
        return offers
