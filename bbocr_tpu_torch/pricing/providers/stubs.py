"""Protocol-shaped placeholder providers (reference ``providers/amazon_stub.py``
/ ``biblio_stub.py``): return no offers, double as protocol fixtures.

Copied from ``bbocr_tpu/pricing/providers/stubs.py``."""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class AmazonStubProvider:
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
        return []


class BiblioStubProvider:
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
        return []
