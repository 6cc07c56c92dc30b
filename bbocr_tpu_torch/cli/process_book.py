"""Single-book CLI: resolve ``books/<id>/`` in the repository (or under
``--books-dir``), run the extractor, validate, save
``book_<id>_enhanced.json`` and print a summary; ``--model list`` lists the
local Ollama models.

    python -m bbocr_tpu_torch.cli.process_book 1 --llm-backend heuristic --ocr-indices 0 1
    python -m bbocr_tpu_torch.cli.process_book --book-dir path/to/book --device cpu

Counterpart of ``bbocr_tpu/cli/process_book.py``, with its options and
defaults: the Ollama backend (``--llm-backend`` also takes ``openai``,
``gemini``, ``heuristic``, and ``tpu``, the PageReader on ``--device``
reading ``checkpoints/vlm.npz`` unless ``--model`` names a checkpoint
file), the CRAFT + CRNN engine (``--ocr-engine tesseract`` for the escape
hatch), a model warm-up unless ``--no-warm-model``, the rotation
search only with ``--auto-rotate``, and the auto-crop to the text region
only with ``--crop-ocr`` (margin ``--crop-margin``, default 16 px). The
extractor takes the process-wide shared engine wrapped in ``BatchingOCR``
(unless ``BB_OCR_BATCHING=0``), which reads each photo with ``readtext``:
no fast path and no re-reads, as with the JAX CLI. With
``BB_OCR_BATCHING=0`` the engine is unwrapped, so upright photos under
1200 px take the fast path and every reading gets the low-confidence and
ISBN re-reads. ``--device`` (default ``cuda``) is where the preprocessing
and the engine run.
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
LLM_BACKENDS = ["ollama", "openai", "gemini", "heuristic", "tpu"]


def find_books_dir(explicit: Optional[str] = None) -> Optional[str]:
    """``explicit`` if given, else the repository's own ``books/``."""
    root = explicit or _BOOKS_DIR
    return root if os.path.isdir(root) else None


def list_ollama_models() -> int:
    try:
        import requests

        resp = requests.get("http://localhost:11434/api/tags", timeout=5)
        for m in resp.json().get("models", []):
            print(m.get("name"))
        return 0
    except Exception as e:  # requests missing, or no server
        print(f"Could not list Ollama models: {e}", file=sys.stderr)
        return 1


def make_extractor(
    device="cuda", use_preprocessing: bool = True, edge_crop_percent: float = 0.0, auto_rotate=False,
    crop_for_ocr: bool = False, crop_margin: int = 16, **kwargs,
) -> BookMetadataExtractor:
    """``BookMetadataExtractor`` with the JAX CLI's defaults, on the
    heuristic backend unless ``llm_backend`` is given, without a warm-up
    unless ``warm_model`` is. ``auto_rotate``: True, False, or None to
    decide per image as the extractor does. Other keywords go to the
    extractor."""
    kwargs.setdefault("llm_backend", "heuristic")
    kwargs.setdefault("warm_model", False)
    return BookMetadataExtractor(
        use_preprocessing=use_preprocessing,
        crop_for_ocr=crop_for_ocr,
        crop_margin=crop_margin,
        edge_crop_percent=edge_crop_percent,
        auto_rotate=auto_rotate,
        device=device,
        **kwargs,
    )


def process_book(
    book_dir: str,
    extractor: Optional[BookMetadataExtractor] = None,
    output_dir: str = "output",
    ocr_indices=None,
    **extractor_kwargs,
) -> dict:
    """Run one book directory through the pipeline and persist the result
    (the extractor given, else one built from ``extractor_kwargs``)."""
    ext = extractor or BookMetadataExtractor(**extractor_kwargs)
    t0 = time.time()
    metadata = ext.process_book_directory(book_dir, ocr_indices)
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


def main(argv=None):
    p = argparse.ArgumentParser(description="Process one book photo set -> metadata JSON")
    p.add_argument("book_id", nargs="?", help="book id under the books dir")
    p.add_argument("--book-dir", help="explicit book directory")
    p.add_argument("--books-dir", help="root directory holding book subdirs")
    p.add_argument("--model", default="gemma3:4b")
    p.add_argument("--llm-backend", default="ollama", choices=LLM_BACKENDS)
    p.add_argument("--ocr-engine", default="tpu", choices=["tpu", "tesseract"])
    p.add_argument("--no-preprocessing", action="store_true")
    p.add_argument("--crop-ocr", action="store_true", help="crop each OCR'd photo to its text region")
    p.add_argument("--crop-margin", type=int, default=16)
    p.add_argument("--edge-crop", type=float, default=0.0)
    p.add_argument("--no-warm-model", action="store_true")
    p.add_argument("--ocr-indices", type=int, nargs="+")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--auto-rotate", action="store_true",
                   help="read each photo at the four right-angle rotations and keep the best")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.model == "list":
        sys.exit(list_ollama_models())

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
    try:
        extractor = make_extractor(
            args.device, not args.no_preprocessing, args.edge_crop, args.auto_rotate, args.crop_ocr, args.crop_margin,
            model=args.model, llm_backend=args.llm_backend, ocr_engine=args.ocr_engine,
            warm_model=not args.no_warm_model,
        )
        process_book(book_dir, extractor=extractor, output_dir=args.output_dir, ocr_indices=args.ocr_indices)
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
