"""Async provider fan-out with per-provider timeout isolation.

Same contract as the reference aggregator
(``pipeline_demo/pricing_api/pricing_api/core/aggregator.py``):
``aggregate_offers(...) -> (offers, errors)``, one asyncio task per
provider bounded by ``wait_for`` (default 8 s), provider failures isolated
into the errors map, offers tagged with their provider and deduped by
(provider, listing_id, isbn_13, isbn_10).

Copied from ``bbocr_tpu/pricing/aggregator.py``. A provider whose HTTP
client library is missing raises ``ImportError`` in its lookup, which is
filed under its name in the errors map like any other failure.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional, Tuple

from bbocr_tpu_torch.pricing.providers.google_books import GoogleBooksProvider
from bbocr_tpu_torch.pricing.providers.abebooks_html import AbeBooksHtmlProvider
from bbocr_tpu_torch.pricing.providers.stubs import AmazonStubProvider, BiblioStubProvider

DEFAULT_PROVIDERS = {
    "google_books": GoogleBooksProvider,
    "amazon": AmazonStubProvider,
    "abebooks": AbeBooksHtmlProvider,
    "biblio": BiblioStubProvider,
}

DEFAULT_TIMEOUT_SECONDS = 8.0


async def aggregate_offers(
    *,
    title: Optional[str] = None,
    authors: Optional[List[str]] = None,
    isbn_13: Optional[str] = None,
    isbn_10: Optional[str] = None,
    publisher: Optional[str] = None,
    publication_date: Optional[str] = None,
    providers: Optional[List[str]] = None,
    timeout_seconds: float = DEFAULT_TIMEOUT_SECONDS,
) -> Tuple[List[Dict[str, Any]], Dict[str, str]]:
    names = providers if providers else list(DEFAULT_PROVIDERS)
    query = {
        "title": title,
        "authors": authors or [],
        "isbn_13": isbn_13,
        "isbn_10": isbn_10,
        "publisher": publisher,
        "publication_date": publication_date,
    }

    instances = []
    errors: Dict[str, str] = {}
    for name in names:
        cls = DEFAULT_PROVIDERS.get(name)
        if cls is None:
            errors[name] = f"unknown provider: {name}"
            continue
        instances.append((name, cls()))

    async def run(name: str, provider) -> Tuple[str, Any]:
        try:
            offers = await asyncio.wait_for(provider.lookup(**query), timeout_seconds)
            return name, offers
        except asyncio.TimeoutError:
            return name, TimeoutError(f"{name} timed out after {timeout_seconds}s")
        except Exception as e:
            return name, e

    results = await asyncio.gather(*(run(n, p) for n, p in instances))

    offers: List[Dict[str, Any]] = []
    seen = set()
    for name, result in results:
        if isinstance(result, Exception):
            errors[name] = str(result)
            continue
        for offer in result or []:
            offer = dict(offer)
            offer["provider"] = name
            key = (
                offer.get("provider"),
                offer.get("listing_id"),
                offer.get("isbn_13"),
                offer.get("isbn_10"),
            )
            if key in seen:
                continue
            seen.add(key)
            offers.append(offer)
    return offers, errors
