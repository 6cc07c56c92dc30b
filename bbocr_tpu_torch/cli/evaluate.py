"""End-to-end evaluation over ground-truthed books: photos -> extractor ->
field accuracy against each book's ``ground_truth.json``.

Counterpart of ``bbocr_tpu/cli/evaluate.py``: exact and fuzzy (ratio >=
0.8) accuracy and CER per field, through the port's
``BookMetadataExtractor`` built with no engine, so that each book's photos
take the process-wide shared engine of ``device`` and the preprocessing
kernels, as the JAX function takes its extractor's.

    python -m bbocr_tpu_torch.cli.evaluate --books-dir books [--device cpu] [--out report.json]

The process exits with 1 when a book raised (its row carries the error).
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from bbocr_tpu_torch.utils.cer import cer

FIELDS = ("title", "authors", "publisher", "year", "isbn_13")
FUZZY_THRESHOLD = 0.8


def _norm(x: Any) -> str:
    if x is None:
        return ""
    if isinstance(x, list):
        return " ".join(str(i) for i in x).strip().lower()
    return str(x).strip().lower()


def fuzzy_ratio(a: str, b: str) -> float:
    if not a or not b:
        return 0.0
    return difflib.SequenceMatcher(None, a, b).ratio()


def score_fields(truth: Dict[str, Any], pred: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    out = {}
    for field in FIELDS:
        t = _norm(truth.get(field))
        p = _norm(pred.get(field))
        ratio = fuzzy_ratio(t, p)
        out[field] = {
            "truth": t,
            "pred": p,
            "exact": bool(t) and t == p,
            "fuzzy": ratio >= FUZZY_THRESHOLD,
            "ratio": round(ratio, 3),
            "cer": round(cer(t, p), 3) if t else None,
        }
    return out


# the fields of data/real/ground_truth.json, scored where the truth has one
# (cli/evaluate_real.py and cli/restructure.py)
REAL_FIELDS = ("title", "authors", "publisher", "year", "isbn_10", "isbn_13")


def score_real_fields(pred: Dict[str, Any], truth: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    out = {}
    for field in REAL_FIELDS:
        t = _norm(truth.get(field))
        if not t:
            continue
        p = _norm(pred.get(field))
        ratio = fuzzy_ratio(t, p)
        out[field] = {
            "truth": t, "pred": p,
            "exact": t == p, "fuzzy": ratio >= FUZZY_THRESHOLD,
            "ratio": round(ratio, 3),
        }
    return out


def evaluate_books(
    books_dir: str,
    *,
    llm_backend: str = "heuristic",
    ocr_engine: str = "tpu",
    limit: Optional[int] = None,
    fast_single: Optional[bool] = None,
    device="cuda",
) -> Dict[str, Any]:
    """The JAX function's summary (``per_field``, ``mean_cer``, ``details``
    with one row per book) over the books of ``books_dir`` that have a
    ``ground_truth.json``, in name order. ``ocr_engine`` takes only the
    default (the CRAFT + CRNN engine)."""
    if ocr_engine != "tpu":
        raise NotImplementedError(
            f"ocr_engine={ocr_engine!r} is not ported yet: see ROADMAP.md Queue 1 item 11")
    from bbocr_tpu_torch.extract import BookMetadataExtractor

    extractor = BookMetadataExtractor(
        llm_backend=llm_backend, warm_model=False, fast_single=fast_single, device=device,
    )
    book_ids = sorted(
        d for d in os.listdir(books_dir)
        if os.path.isdir(os.path.join(books_dir, d))
        and os.path.isfile(os.path.join(books_dir, d, "ground_truth.json"))
    )
    if limit:
        book_ids = book_ids[:limit]

    per_book: List[Dict[str, Any]] = []
    t0 = time.time()
    for book_id in book_ids:
        book_dir = os.path.join(books_dir, book_id)
        with open(os.path.join(book_dir, "ground_truth.json")) as f:
            truth = json.load(f)
        t_book = time.time()
        try:
            pred = extractor.process_book_directory(book_dir)
            fields = score_fields(truth, pred)
            per_book.append(
                {
                    "book": book_id,
                    "seconds": round(time.time() - t_book, 2),
                    "fields": fields,
                    "error": None,
                }
            )
        except Exception as e:  # the row names it; main() exits with 1
            per_book.append({"book": book_id, "error": str(e), "fields": {}})

    summary: Dict[str, Any] = {
        "books": len(per_book),
        "total_seconds": round(time.time() - t0, 2),
        "per_field": {},
        "details": per_book,
    }
    for field in FIELDS:
        rows = [b["fields"][field] for b in per_book if field in b.get("fields", {})]
        if not rows:
            continue
        n = len(rows)
        cers = [r["cer"] for r in rows if r["cer"] is not None]
        summary["per_field"][field] = {
            "exact_acc": round(sum(r["exact"] for r in rows) / n, 3),
            "fuzzy_acc": round(sum(r["fuzzy"] for r in rows) / n, 3),
            "mean_cer": round(sum(cers) / len(cers), 3) if cers else None,
        }
    all_cers = [
        r["cer"]
        for b in per_book
        for r in b.get("fields", {}).values()
        if r.get("cer") is not None
    ]
    summary["mean_cer"] = round(sum(all_cers) / len(all_cers), 3) if all_cers else None
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Evaluate the pipeline on ground-truthed books")
    p.add_argument("--books-dir", default="books")
    p.add_argument("--llm-backend", default="heuristic")
    p.add_argument("--ocr-engine", default="tpu")
    p.add_argument("--limit", type=int)
    p.add_argument("--out", default=None, help="write full JSON report here")
    p.add_argument("--fast", dest="fast", action="store_true", default=None,
                   help="force the single-dispatch OCR path")
    p.add_argument("--no-fast", dest="fast", action="store_false",
                   help="force the full (3-dispatch) OCR path")
    p.add_argument("--device", default="cuda", help="torch device of the engine and the preprocessing")
    args = p.parse_args(argv)
    summary = evaluate_books(
        args.books_dir,
        llm_backend=args.llm_backend,
        ocr_engine=args.ocr_engine,
        limit=args.limit,
        fast_single=args.fast,
        device=args.device,
    )
    report = {k: v for k, v in summary.items() if k != "details"}
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"full report -> {args.out}")
    failed = [b["book"] for b in summary["details"] if b.get("error")]
    if failed:
        print(f"books that raised: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
