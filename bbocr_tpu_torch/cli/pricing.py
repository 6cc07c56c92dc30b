"""Pricing lookup CLI (role of the reference's ``pricing_api/cli.py``).

Counterpart of ``bbocr_tpu/cli/pricing.py``: the same flags and the same
JSON on stdout.

    python -m bbocr_tpu_torch.cli.pricing --title "The Sea" --author "John Banville" \
        --year 2005 --providers abebooks google_books
    python -m bbocr_tpu_torch.cli.pricing --from-json output/book_1_enhanced.json
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from bbocr_tpu_torch.pricing import aggregate_offers
from bbocr_tpu_torch.pricing.select import merge_offer_into_metadata, select_best_offer


def main(argv=None):
    p = argparse.ArgumentParser(description="Query pricing providers for a book")
    p.add_argument("--title")
    p.add_argument("--author", action="append", default=[])
    p.add_argument("--isbn-13")
    p.add_argument("--isbn-10")
    p.add_argument("--publisher")
    p.add_argument("--year")
    p.add_argument("--providers", nargs="+")
    p.add_argument("--timeout", type=float, default=8.0)
    p.add_argument("--from-json", help="load the query from an extractor output JSON")
    p.add_argument("--select", action="store_true", help="also pick the best offer + merged record")
    args = p.parse_args(argv)

    query = {
        "title": args.title,
        "authors": args.author,
        "isbn_13": args.isbn_13,
        "isbn_10": args.isbn_10,
        "publisher": args.publisher,
        "publication_date": args.year,
    }
    if args.from_json:
        with open(args.from_json) as f:
            md = json.load(f)
        query = {
            "title": md.get("title"),
            "authors": md.get("authors") or [],
            "isbn_13": md.get("isbn_13"),
            "isbn_10": md.get("isbn_10"),
            "publisher": md.get("publisher"),
            "publication_date": md.get("publication_date") or md.get("year"),
        }
    if not any(query.values()):
        p.error("empty query: provide --title/--isbn-13/... or --from-json")

    offers, errors = asyncio.run(
        aggregate_offers(**query, providers=args.providers, timeout_seconds=args.timeout)
    )
    out = {"query": query, "offers": offers, "errors": errors}
    if args.select:
        best, reason = select_best_offer(query, offers)
        out["best_offer"] = best
        out["selection_reason"] = reason
        out["merged"] = merge_offer_into_metadata(query, best)
    json.dump(out, sys.stdout, indent=2)
    print()


if __name__ == "__main__":
    main()
