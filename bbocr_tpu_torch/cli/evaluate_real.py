"""Real-photo evaluation: the repository's own book photos, end to end.

Counterpart of ``bbocr_tpu/cli/evaluate_real.py``, the JAX package's
accuracy gate, on the port's engine. The corpus under ``data/real/`` holds
21 books (29 photos: five covers and 24 camera photos of 2400x1800) with
hand-transcribed ground truth in ``data/real/ground_truth.json`` and
recorded EasyOCR outputs in ``data/real/easyocr_reference.json``. Each photo
is loaded in gray as Pillow's ``convert("L")`` gives it, read by an
unwrapped ``OCREngine`` at the four right-angle rotations
(``runtime/orient.py::read_with_rotations``) and the winning rotation
re-read where its confidence is low; no preprocessing, no ISBN re-read.

Metrics, per book and corpus-wide:

- word_recall: fraction of ground-truth phrase words (len >= 3, normalized)
  found in the OCR output, computed identically for the engine and for the
  recorded EasyOCR text;
- phrase CER: mean best-substring CER of the ground-truth phrases;
- field accuracy: the heuristic structurer's title/authors/publisher/year/
  isbn against ground truth, exact and fuzzy (ratio >= 0.8).

The summary keeps the JAX package's keys (``tpu_mean_word_recall``, ...),
so ``cli/restructure.py`` and ``cli/ab_summary.py`` read both packages'
artifacts.

    python -m bbocr_tpu_torch.cli.evaluate_real [--device cpu] [--out eval_real.json]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from bbocr_tpu_torch.cli.evaluate import REAL_FIELDS as FIELDS
from bbocr_tpu_torch.cli.evaluate import score_real_fields
from bbocr_tpu_torch.extract.heuristics import heuristic_extract, heuristic_extract_lines
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.runtime.orient import read_with_rotations, rotation_score  # noqa: F401  (re-exported)

REAL_DIR_DEFAULT = os.path.join("data", "real")

_WORD_RE = re.compile(r"[A-Z0-9']+")


def _words(text: str, min_len: int = 3) -> List[str]:
    """Normalized scoring words: uppercase alphanumeric runs, len >= min_len."""
    return [w for w in _WORD_RE.findall(text.upper()) if len(w) >= min_len]


def substring_cer(phrase: str, text: str) -> float:
    """CER of ``phrase`` against its best-matching substring of ``text``.

    Standard approximate-substring edit distance: DP over the phrase with
    free start position in the text (first row zeros), min over end
    positions, divided by phrase length. Both OCR outputs are unordered
    bags of lines, so corpus CER on the concatenation would be dominated by
    ordering; per-phrase best-substring alignment is order-free and is
    computed IDENTICALLY for the engine and the recorded EasyOCR text,
    which is what makes the parity comparison meaningful.
    """
    p = re.sub(r"\s+", " ", phrase.upper().strip())
    t = re.sub(r"\s+", " ", text.upper().strip())
    if not p:
        return 0.0
    if not t:
        return 1.0
    prev = np.zeros(len(t) + 1, np.int32)
    for i, pc in enumerate(p, 1):
        cur = np.empty(len(t) + 1, np.int32)
        cur[0] = i
        for j, tc in enumerate(t, 1):
            cur[j] = min(
                prev[j] + 1,
                cur[j - 1] + 1,
                prev[j - 1] + (pc != tc),
            )
        prev = cur
    return float(prev.min()) / len(p)


def phrase_cer(phrases: Sequence[str], ocr_text: str) -> Optional[float]:
    """Mean per-phrase best-substring CER (lower is better)."""
    vals = [substring_cer(p, ocr_text) for p in phrases if p.strip()]
    return round(sum(vals) / len(vals), 3) if vals else None


def word_recall(phrases: Sequence[str], ocr_text: str) -> Dict[str, Any]:
    """Fraction of ground-truth phrase words present in the OCR text.

    A GT word counts as found if it appears as a token OR as a substring of
    the concatenated OCR text (handles OCR merging/splitting of words).
    """
    gt_words: List[str] = []
    for p in phrases:
        gt_words.extend(_words(p))
    if not gt_words:
        return {"recall": None, "found": 0, "total": 0}
    ocr_tokens = set(_words(ocr_text, min_len=1))
    ocr_blob = re.sub(r"[^A-Z0-9']", "", ocr_text.upper())
    found = sum(1 for w in gt_words if w in ocr_tokens or w in ocr_blob)
    return {
        "recall": round(found / len(gt_words), 3),
        "found": found,
        "total": len(gt_words),
    }


# Pillow's convert("L"): ITU-R 601-2 luma in 16-bit fixed point,
# (19595 R + 38470 G + 7471 B + 0x8000) >> 16 (not cv2's 15-bit RGB2GRAY)
_L24 = np.array([19595, 38470, 7471], np.int32)


def _load_gray(path: str) -> np.ndarray:
    """The photo in gray as ``np.asarray(Image.open(path).convert("L"),
    np.float32)`` gives it, without Pillow: ``io.load_rgb`` (PNG reader,
    C++ JPEG decoder) and Pillow's fixed-point luma."""
    rgb = load_rgb(path)
    return ((rgb[..., :3].astype(np.int32) @ _L24 + 0x8000) >> 16).astype(np.float32)


def evaluate_real(
    real_dir: str = REAL_DIR_DEFAULT,
    *,
    craft: str = os.path.join("checkpoints", "craft.npz"),
    crnn: str = os.path.join("checkpoints", "crnn.npz"),
    auto_rotate: bool = True,
    limit: Optional[int] = None,
    books_filter: Optional[Sequence[str]] = None,
    detect_pool: int = 1,
    reread_conf_ths: float = 0.5,
    device="cuda",
) -> Dict[str, Any]:
    """The JAX function's summary over ``real_dir``'s books, read by an
    ``OCREngine`` on ``device``."""
    from bbocr_tpu_torch.decode import group_lines
    from bbocr_tpu_torch.runtime.engine import EngineConfig, OCREngine

    with open(os.path.join(real_dir, "ground_truth.json")) as f:
        gt = json.load(f)["books"]
    easy_path = os.path.join(real_dir, "easyocr_reference.json")
    easy = {}
    if os.path.isfile(easy_path):
        with open(easy_path) as f:
            easy = json.load(f)

    config = EngineConfig(detect_pool=detect_pool) if detect_pool > 1 else EngineConfig()
    engine = OCREngine.from_checkpoint(craft, crnn, config=config, device=device)

    book_keys = sorted(gt.keys())
    if books_filter:
        book_keys = [k for k in book_keys if k in set(books_filter)]
    if limit:
        book_keys = book_keys[:limit]

    per_book: List[Dict[str, Any]] = []
    t0 = time.time()
    for key in book_keys:
        entry = gt[key]
        texts: List[str] = []
        lines_all: List[Tuple[str, float, float]] = []
        rotations: List[int] = []
        results_dump: List[Tuple[str, float]] = []
        t_book = time.time()
        for img_i, (img_name, sideways) in enumerate(zip(entry["images"], entry.get("sideways", []))):
            # photos/<id> images live in that directory; covers/<name> images
            # sit directly under covers/.
            path = os.path.join(real_dir, *key.split("/"), img_name)
            if not os.path.isfile(path):
                path = os.path.join(real_dir, os.path.dirname(key), img_name)
            img = _load_gray(path)
            if auto_rotate:
                res, k = read_with_rotations(engine, img, reread_conf_ths=reread_conf_ths)
            else:
                res, k = engine.readtext(img), 0
                if reread_conf_ths > 0 and res:
                    res = engine.reread_low_conf(img, res, conf_ths=reread_conf_ths)
            rotations.append(k)
            texts.append(" ".join(t for _, t, _ in res))
            results_dump.extend((t, round(float(c), 3)) for _, t, c in res)
            # Structurer input: visual lines with prominence (mean conf +
            # relative text height). Pattern fields scan everything;
            # title/author selection weighs confident big text.
            if res:
                groups = group_lines([r[0] for r in res])
                heights = []
                for line in groups:
                    hs = [
                        float(np.linalg.norm(np.asarray(res[i][0])[3] - np.asarray(res[i][0])[0]))
                        for i in line
                    ]
                    heights.append(sum(hs) / len(hs))
                h_max = max(heights) if heights else 1.0
                for line, h in zip(groups, heights):
                    txt = " ".join(res[i][1] for i in line)
                    conf = sum(float(res[i][2]) for i in line) / len(line)
                    lines_all.append((txt, conf, h / max(h_max, 1e-6), img_i))
        ocr_text = " ".join(texts)
        recall = word_recall(entry.get("phrases", []), ocr_text)
        cer = phrase_cer(entry.get("phrases", []), ocr_text)

        if lines_all:
            pred = heuristic_extract_lines(lines_all)
        else:
            pred = heuristic_extract(ocr_text)
        fields = score_real_fields(pred, entry)

        row: Dict[str, Any] = {
            "book": key,
            "seconds": round(time.time() - t_book, 2),
            "images": len(entry["images"]),
            "rotations": rotations,
            "tpu_word_recall": recall,
            "tpu_phrase_cer": cer,
            "tpu_text_chars": len(ocr_text),
            "fields": fields,
            "ocr_text": ocr_text,
            "results": results_dump,
            # The structurer's exact input (text, conf, rel_height, img_i)
            # per visual line: committed eval artifacts then support
            # OFFLINE structurer iteration (cli/restructure.py) without
            # re-running the engine.
            "lines": [
                [t, round(c, 3), round(h, 3), img] for t, c, h, img in lines_all
            ],
        }
        ref_key = entry.get("easyocr_reference_key")
        if ref_key and ref_key in easy:
            easy_text = easy[ref_key]["easyocr_text"]
            er = word_recall(entry.get("phrases", []), easy_text)
            row["easyocr_word_recall"] = er
            row["easyocr_phrase_cer"] = phrase_cer(entry.get("phrases", []), easy_text)
            row["easyocr_text_chars"] = len(easy_text)
            row["easyocr_seconds"] = easy[ref_key].get("easyocr_seconds")
        per_book.append(row)

    ecfg = engine.config
    summary: Dict[str, Any] = {
        "books": len(per_book),
        "total_seconds": round(time.time() - t0, 2),
        # self-describing A/B artifact: the serving knobs this run used
        "engine_config": {
            "wire_bits": ecfg.wire_bits,
            "host_rectify": ecfg.host_rectify,
            "detect_coarse": ecfg.detect_coarse,
            "decoder": ecfg.decoder,
            "detect_pool": ecfg.detect_pool,
            "detail_scale": os.environ.get("BB_OCR_DETAIL_SCALE"),
        },
        "details": per_book,
    }
    recs = [b["tpu_word_recall"]["recall"] for b in per_book
            if b["tpu_word_recall"]["recall"] is not None]
    summary["tpu_mean_word_recall"] = round(sum(recs) / len(recs), 3) if recs else None
    cers = [b["tpu_phrase_cer"] for b in per_book if b["tpu_phrase_cer"] is not None]
    summary["tpu_mean_phrase_cer"] = round(sum(cers) / len(cers), 3) if cers else None
    pairs = [
        (b["tpu_word_recall"]["recall"], b["easyocr_word_recall"]["recall"])
        for b in per_book if "easyocr_word_recall" in b
    ]
    if pairs:
        summary["paired_covers"] = len(pairs)
        summary["tpu_mean_word_recall_on_paired"] = round(sum(p[0] for p in pairs) / len(pairs), 3)
        summary["easyocr_mean_word_recall_on_paired"] = round(sum(p[1] for p in pairs) / len(pairs), 3)
        cpairs = [
            (b["tpu_phrase_cer"], b["easyocr_phrase_cer"])
            for b in per_book
            if b.get("easyocr_phrase_cer") is not None and b["tpu_phrase_cer"] is not None
        ]
        if cpairs:
            summary["tpu_mean_phrase_cer_on_paired"] = round(sum(p[0] for p in cpairs) / len(cpairs), 3)
            summary["easyocr_mean_phrase_cer_on_paired"] = round(sum(p[1] for p in cpairs) / len(cpairs), 3)
    summary["per_field"] = {}
    for field in FIELDS:
        rows = [b["fields"][field] for b in per_book if field in b["fields"]]
        if not rows:
            continue
        n = len(rows)
        summary["per_field"][field] = {
            "n": n,
            "exact_acc": round(sum(r["exact"] for r in rows) / n, 3),
            "fuzzy_acc": round(sum(r["fuzzy"] for r in rows) / n, 3),
        }
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate on the reference's real book photos")
    p.add_argument("--real-dir", default=REAL_DIR_DEFAULT)
    p.add_argument("--craft", default=os.path.join("checkpoints", "craft.npz"))
    p.add_argument("--crnn", default=os.path.join("checkpoints", "crnn.npz"))
    p.add_argument("--no-auto-rotate", action="store_true")
    p.add_argument("--limit", type=int)
    p.add_argument("--books", nargs="*", help="restrict to these book keys")
    p.add_argument("--out", default=None)
    p.add_argument("--detect-pool", type=int, default=1,
                   help="on-device pooling before CRAFT on hi-res canvases")
    p.add_argument("--no-reread", action="store_true",
                   help="disable the low-confidence full-res re-read pass")
    p.add_argument("--device", default="cuda", help="torch device of the engine")
    args = p.parse_args(argv)
    summary = evaluate_real(
        args.real_dir,
        craft=args.craft,
        crnn=args.crnn,
        auto_rotate=not args.no_auto_rotate,
        limit=args.limit,
        books_filter=args.books,
        detect_pool=args.detect_pool,
        reread_conf_ths=0.0 if args.no_reread else 0.5,
        device=args.device,
    )
    report = {k: v for k, v in summary.items() if k != "details"}
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"full report -> {args.out}")


if __name__ == "__main__":
    main()
