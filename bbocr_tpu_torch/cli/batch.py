"""Batch CLI driver over ``books/*``.

Counterpart of ``bbocr_tpu/cli/batch.py``: process many book directories
with either a shared-extractor serial loop or a thread pool, track stats,
and write ``<output_dir>/batch_processing_summary.json``. The OCR engine is
process-wide and internally batched, so the thread pool parallelises the
host work (I/O, LLM calls) while the device work queues on the engine.

    python -m bbocr_tpu_torch.cli.batch --books-dir books --max-workers 2 --llm-backend heuristic
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Dict, List, Optional

from bbocr_tpu_torch.cli.process_book import LLM_BACKENDS, process_book
from bbocr_tpu_torch.extract import BookMetadataExtractor, validate_metadata


class BatchProcessor:
    def __init__(self, books_dir: str, output_dir: str = "batch_output", **extractor_kwargs):
        self.books_dir = books_dir
        self.output_dir = output_dir
        self.extractor_kwargs = extractor_kwargs
        self.stats = {
            "total": 0, "succeeded": 0, "failed": 0, "validation_issues": 0,
        }
        self._stats_lock = threading.Lock()
        self.results: Dict[str, Dict] = {}

    def discover(self) -> List[str]:
        return sorted(
            d for d in os.listdir(self.books_dir)
            if os.path.isdir(os.path.join(self.books_dir, d))
        )

    def _process_one(self, book_id: str, extractor: Optional[BookMetadataExtractor]) -> None:
        book_dir = os.path.join(self.books_dir, book_id)
        try:
            metadata = process_book(
                book_dir,
                extractor=extractor,
                output_dir=self.output_dir,
                **(self.extractor_kwargs if extractor is None else {}),
            )
            ok, issues = validate_metadata(metadata)
            with self._stats_lock:
                self.stats["succeeded"] += 1
                if not ok:
                    self.stats["validation_issues"] += 1
                self.results[book_id] = {"status": "ok", "issues": issues}
        except Exception as e:
            with self._stats_lock:
                self.stats["failed"] += 1
                self.results[book_id] = {"status": "error", "error": str(e)}

    def process_books(self, book_ids: Optional[List[str]] = None, max_workers: int = 1) -> Dict:
        ids = book_ids or self.discover()
        self.stats["total"] = len(ids)
        t0 = time.time()
        if max_workers <= 1:
            # serial path with one shared extractor (model/engine reuse)
            shared = BookMetadataExtractor(**self.extractor_kwargs)
            for book_id in ids:
                self._process_one(book_id, shared)
        else:
            with ThreadPoolExecutor(max_workers=max_workers) as pool:
                futures = [pool.submit(self._process_one, b, None) for b in ids]
                for f in as_completed(futures):
                    f.result()
        elapsed = time.time() - t0
        summary = {
            **self.stats,
            "total_time_seconds": elapsed,
            "average_time_per_book": elapsed / max(len(ids), 1),
            "results": self.results,
        }
        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir, "batch_processing_summary.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=2)
        print(
            f"batch done: {self.stats['succeeded']}/{self.stats['total']} ok, "
            f"{self.stats['failed']} failed, {elapsed:.1f}s total "
            f"({summary['average_time_per_book']:.2f}s/book) -> {path}"
        )
        return summary


def main(argv=None):
    p = argparse.ArgumentParser(description="Batch-process book directories")
    p.add_argument("--books-dir", default="books")
    p.add_argument("--output-dir", default="batch_output")
    p.add_argument("--book-ids", nargs="+")
    p.add_argument("--max-workers", type=int, default=1)
    p.add_argument("--model", default="gemma3:4b")
    p.add_argument("--llm-backend", default="ollama", choices=LLM_BACKENDS)
    p.add_argument("--ocr-engine", default="tpu", choices=["tpu", "tesseract"])
    p.add_argument("--no-preprocessing", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device of the preprocessing and the engine")
    args = p.parse_args(argv)

    if not os.path.isdir(args.books_dir):
        print(f"not a directory: {args.books_dir}", file=sys.stderr)
        sys.exit(1)
    bp = BatchProcessor(
        args.books_dir,
        output_dir=args.output_dir,
        model=args.model,
        llm_backend=args.llm_backend,
        ocr_engine=args.ocr_engine,
        use_preprocessing=not args.no_preprocessing,
        warm_model=False,
        device=args.device,
    )
    return bp.process_books(args.book_ids, max_workers=args.max_workers)


if __name__ == "__main__":
    main()
