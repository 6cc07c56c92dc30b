"""Google Books volumes API provider (metadata-only offers).

Counterpart of ``bbocr_tpu/pricing/providers/google_books.py``, with the
same query grammar (isbn:/intitle:/inauthor:/inpublisher: terms ALL
included when known, plus-joined with spaces replaced by '+', bare title
as last resort; maxResults=5; optional GOOGLE_BOOKS_API_KEY) and the same
offer mapping (currency/amount None, source "metadata", plus description,
page_count, categories and language).

``httpx`` is imported only when a lookup reaches the network, inside
``_async_client``; without it that raises ``ImportError`` naming it, and
the aggregator files it under the provider's error, as it files a network
error. Tests replace ``_async_client`` with a canned client.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from bbocr_tpu_torch.pricing.parse import make_offer

API_URL = "https://www.googleapis.com/books/v1/volumes"


def _async_client(**kwargs):
    """``httpx.AsyncClient(**kwargs)``."""
    try:
        import httpx
    except ImportError as e:
        raise ImportError("the google_books provider needs the httpx package") from e
    return httpx.AsyncClient(**kwargs)


class GoogleBooksProvider:
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
        terms: List[str] = []
        if isbn_13:
            terms.append(f"isbn:{isbn_13}")
        if isbn_10:
            terms.append(f"isbn:{isbn_10}")
        if title:
            terms.append(f"intitle:{title}")
        for a in authors or []:
            if a:
                terms.append(f"inauthor:{a}")
        if publisher:
            terms.append(f"inpublisher:{publisher}")
        q = "+".join(t.replace(" ", "+") for t in terms) or (title or "")
        if not q:
            return []

        params: Dict[str, Any] = {"q": q, "maxResults": 5}
        api_key = os.getenv("GOOGLE_BOOKS_API_KEY")
        if api_key:
            params["key"] = api_key

        async with _async_client(timeout=6.0) as client:
            resp = await client.get(API_URL, params=params)
            resp.raise_for_status()
            data = resp.json()

        offers: List[Dict[str, Any]] = []
        for item in data.get("items", []) or []:
            info = item.get("volumeInfo", {}) or {}
            ids = {
                d.get("type"): d.get("identifier")
                for d in info.get("industryIdentifiers", []) or []
            }
            offer = make_offer(
                "google_books",
                listing_id=item.get("id"),
                title=info.get("title"),
                authors=info.get("authors") or [],
                publisher=info.get("publisher"),
                publication_date=info.get("publishedDate"),
                isbn_13=ids.get("ISBN_13"),
                isbn_10=ids.get("ISBN_10"),
                currency=None,
                amount=None,
                url=info.get("infoLink") or item.get("selfLink"),
                source="metadata",
            )
            # reference enrichment extras (google_books.py:54-58)
            offer["description"] = info.get("description")
            offer["page_count"] = info.get("pageCount")
            offer["categories"] = info.get("categories")
            offer["language"] = info.get("language")
            offers.append(offer)
        return offers
