"""VLM backend bake-off harness.

Counterpart of ``bbocr_tpu/cli/vlm_bench.py``, with its options and
output: each backend (``ollama``, ``openai``, ``gemini`` when configured,
``heuristic``, and ``tpu``, the PageReader on ``--device``) runs the
extractor's standard prompts over the ground-truthed books, recording the
seconds per book and the exact and fuzzy field accuracy
(``cli/evaluate.py::score_fields``).

    python -m bbocr_tpu_torch.cli.vlm_bench --books-dir books \\
        --backend tpu --backend heuristic [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List

from bbocr_tpu_torch.cli.evaluate import FIELDS, score_fields


def parse_backend(spec: str):
    """'ollama:gemma3:4b' -> ('ollama', 'gemma3:4b'); 'heuristic' -> (...)"""
    if ":" in spec:
        backend, model = spec.split(":", 1)
    else:
        backend, model = spec, ""
    return backend, model


def bench_backend(backend: str, model: str, books_dir: str, limit: int, device="cuda") -> Dict[str, Any]:
    from bbocr_tpu_torch.extract import BookMetadataExtractor

    extractor = BookMetadataExtractor(
        model=model or "gemma3:4b",
        llm_backend=backend,
        warm_model=False,
        device=device,
    )
    book_ids = sorted(
        d for d in os.listdir(books_dir)
        if os.path.isfile(os.path.join(books_dir, d, "ground_truth.json"))
    )[:limit]
    rows: List[Dict[str, Any]] = []
    for book_id in book_ids:
        book_dir = os.path.join(books_dir, book_id)
        with open(os.path.join(book_dir, "ground_truth.json")) as f:
            truth = json.load(f)
        t0 = time.time()
        try:
            pred = extractor.process_book_directory(book_dir)
            rows.append(
                {
                    "book": book_id,
                    "seconds": round(time.time() - t0, 2),
                    "fields": score_fields(truth, pred),
                }
            )
        except Exception as e:
            rows.append({"book": book_id, "seconds": round(time.time() - t0, 2), "error": str(e)})

    scored = [r for r in rows if "fields" in r]
    summary: Dict[str, Any] = {
        "backend": backend,
        "model": model,
        "books": len(rows),
        "errors": len(rows) - len(scored),
        "mean_seconds": round(sum(r["seconds"] for r in rows) / max(len(rows), 1), 2),
    }
    for field in FIELDS:
        vals = [r["fields"][field] for r in scored]
        if vals:
            summary[f"{field}_fuzzy_acc"] = round(sum(v["fuzzy"] for v in vals) / len(vals), 3)
    summary["details"] = rows
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description="Benchmark VLM/structurer backends")
    p.add_argument("--books-dir", default="books")
    p.add_argument(
        "--backend", action="append", default=[],
        help="backend[:model], e.g. ollama:gemma3:4b, gemini:gemini-2.5-flash, heuristic, tpu",
    )
    p.add_argument("--limit", type=int, default=5)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="torch device of the engine, the preprocessing and the PageReader")
    args = p.parse_args(argv)
    specs = args.backend or ["heuristic"]
    results = []
    for spec in specs:
        backend, model = parse_backend(spec)
        summary = bench_backend(backend, model, args.books_dir, args.limit, args.device)
        results.append(summary)
        brief = {k: v for k, v in summary.items() if k != "details"}
        print(json.dumps(brief))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
