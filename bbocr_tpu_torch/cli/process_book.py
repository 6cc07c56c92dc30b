"""Single-book CLI: resolve ``books/<id>/`` in the repository (or under
``--books-dir``), run the extractor on the heuristic backend, validate,
save ``book_<id>_enhanced.json`` and print a summary.

    python -m bbocr_tpu_torch.cli.process_book 1 --ocr-indices 0 1
    python -m bbocr_tpu_torch.cli.process_book --book-dir path/to/book --device cpu

Only the knobs of the ported path are offered: no rotation search, no
re-reads, no fast path, no LLM.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

from bbocr_tpu_torch.extract import BookMetadataExtractor, validate_metadata


_BOOKS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "books")


def find_books_dir(explicit: Optional[str] = None) -> Optional[str]:
    """``explicit`` if given, else the repository's own ``books/``."""
    root = explicit or _BOOKS_DIR
    return root if os.path.isdir(root) else None


def make_extractor(device="cuda", use_preprocessing: bool = True, edge_crop_percent: float = 0.0) -> BookMetadataExtractor:
    """The ported configuration of ``BookMetadataExtractor``."""
    return BookMetadataExtractor(
        llm_backend="heuristic",
        use_preprocessing=use_preprocessing,
        crop_for_ocr=False,
        edge_crop_percent=edge_crop_percent,
        auto_rotate=False,
        reread_low_conf=False,
        isbn_reread=False,
        fast_single=False,
        warm_model=False,
        device=device,
    )


def process_book(book_dir: str, extractor: BookMetadataExtractor, output_dir: str = "output", ocr_indices=None) -> dict:
    """Run one book directory through the pipeline and persist the result."""
    t0 = time.time()
    metadata = extractor.process_book_directory(book_dir, ocr_indices)
    elapsed = time.time() - t0
    ok, issues = validate_metadata(metadata)
    book_id = os.path.basename(os.path.normpath(book_dir))
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, f"book_{book_id}_enhanced.json")
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(metadata, f, indent=2, ensure_ascii=False)
    print(f"book {book_id}: {elapsed:.2f}s -> {out_path}")
    print(f"  title:   {metadata.get('title')}")
    print(f"  authors: {', '.join(metadata.get('authors') or []) or None}")
    print(f"  year:    {metadata.get('year')}  isbn13: {metadata.get('isbn_13')}")
    if not ok:
        print(f"  validation issues: {issues}")
    return metadata


def main():
    p = argparse.ArgumentParser(description="Process one book photo set -> metadata JSON")
    p.add_argument("book_id", nargs="?", help="book id under the books dir")
    p.add_argument("--book-dir", help="explicit book directory")
    p.add_argument("--books-dir", help="root directory holding book subdirs")
    p.add_argument("--llm-backend", default="heuristic", choices=["heuristic"])
    p.add_argument("--no-preprocessing", action="store_true")
    p.add_argument("--edge-crop", type=float, default=0.0)
    p.add_argument("--ocr-indices", type=int, nargs="+")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    if args.book_dir:
        book_dir = args.book_dir
    else:
        if not args.book_id:
            p.error("provide a book_id or --book-dir")
        root = find_books_dir(args.books_dir)
        if root is None:
            p.error("no books directory found (use --books-dir)")
        book_dir = os.path.join(root, args.book_id)
    if not os.path.isdir(book_dir):
        p.error(f"not a directory: {book_dir}")
    extractor = make_extractor(args.device, not args.no_preprocessing, args.edge_crop)
    try:
        process_book(book_dir, extractor, output_dir=args.output_dir, ocr_indices=args.ocr_indices)
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
