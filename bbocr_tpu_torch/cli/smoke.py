"""End-to-end smoke runner.

Counterpart of ``bbocr_tpu/cli/smoke.py``: push the first book of a books
directory through the pipeline via the CLI driver, and check that an
output JSON lands with the expected contract. Exit code 0 = healthy.

    python -m bbocr_tpu_torch.cli.smoke --device cpu          # synthetic book
    python -m bbocr_tpu_torch.cli.smoke --books-dir books --device cpu

Without ``--books-dir`` it renders one synthetic book with
``cli/make_examples.py``, which draws with Pillow (``ImportError`` naming
it where it is missing).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Pipeline smoke test")
    p.add_argument("--books-dir", default=None, help="existing books dir (default: render one)")
    p.add_argument("--llm-backend", default="heuristic")
    p.add_argument("--ocr-engine", default="tpu")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    workdir = tempfile.mkdtemp(prefix="bbocr_smoke_")
    books_dir = args.books_dir
    if books_dir is None:
        from bbocr_tpu_torch.cli.make_examples import make_book

        books_dir = os.path.join(workdir, "books")
        make_book(books_dir, 0, seed=42)
        print(f"rendered synthetic book -> {books_dir}/1")

    book_id = sorted(
        d for d in os.listdir(books_dir) if os.path.isdir(os.path.join(books_dir, d))
    )[0]

    from bbocr_tpu_torch.cli.process_book import process_book

    out_dir = os.path.join(workdir, "output")
    metadata = process_book(
        os.path.join(books_dir, book_id),
        output_dir=out_dir,
        llm_backend=args.llm_backend,
        ocr_engine=args.ocr_engine,
        warm_model=False,
        device=args.device,
    )

    out_path = os.path.join(out_dir, f"book_{book_id}_enhanced.json")
    ok = True
    if not os.path.isfile(out_path):
        print("FAIL: output JSON missing")
        ok = False
    else:
        with open(out_path) as f:
            saved = json.load(f)
        for key in ("title", "authors", "isbn_13", "_processing_info"):
            if key not in saved:
                print(f"FAIL: contract key missing: {key}")
                ok = False
    if metadata.get("_processing_info", {}).get("total_images") != 3:
        print("FAIL: expected 3 images processed")
        ok = False
    print("SMOKE PASS" if ok else "SMOKE FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
