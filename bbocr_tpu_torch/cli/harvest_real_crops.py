"""Harvest labeled REAL text crops from the hand-transcribed eval corpus.

Counterpart of ``bbocr_tpu/cli/harvest_real_crops.py`` on the port's
engine. It runs the serving engine on ``data/real`` images, re-warps every
detected quad exactly as recognize saw it (the device warp from the
letterboxed canvas), fuzzy-aligns each decode to a contiguous word span of
a ground-truth phrase, and writes the crops whose alignment is confident as
(png, label) pairs with a ``labels.json`` that ``cli/train --val-real DIR``
reads.

Labels come from the GT span (not the decode), so a bad recognizer still
yields correct labels as long as the alignment is unambiguous; crops that
align to nothing (texture junk, decorations) are skipped on purpose.

Photos are read as OpenCV's ``IMREAD_GRAYSCALE`` reads them
(``io.imread_gray``: libjpeg's luma plane, libpng's RGB-to-gray rule), and
the crops are written by ``io.encode_png``: the same pixels as the JAX
tool's ``cv2.imwrite``, other PNG bytes. Neither OpenCV nor Pillow is needed.

    python -m bbocr_tpu_torch.cli.harvest_real_crops [--out data/real_crops] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import List, Optional, Tuple

import numpy as np


def _norm(s: str) -> str:
    return re.sub(r"\s+", " ", s.upper().strip())


def _lev(a: str, b: str) -> int:
    prev = np.arange(len(b) + 1, dtype=np.int32)
    for i, ca in enumerate(a, 1):
        cur = np.empty(len(b) + 1, np.int32)
        cur[0] = i
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return int(prev[-1])


def best_span_label(
    crop_text: str, phrases: List[str], max_cer: float = 0.45
) -> Tuple[Optional[str], float]:
    """Best contiguous word-span of any GT phrase for this decode.

    Returns (span with original casing, span CER) or (None, best_cer).
    """
    span, cer, _ = best_span_with_margin(crop_text, phrases)
    return (span, cer) if span is not None and cer <= max_cer else (None, cer)


def best_span_with_margin(
    crop_text: str, phrases: List[str]
) -> Tuple[Optional[str], float, float]:
    """Like best_span_label, plus the cross-phrase ambiguity margin.

    Returns (best span, its CER, runner_cer) where runner_cer is the best
    CER any OTHER phrase achieves. A large (runner_cer - cer) means the
    decode identifies its source line even when the decode itself is bad,
    which lets a synthetic-page harvest keep the hard crops (decode CER
    0.3-0.6) that a flat CER gate throws away."""
    c = _norm(crop_text)
    if len(c) < 3:
        return None, 1.0, 1.0
    per_phrase: List[Tuple[float, Optional[str]]] = []
    for ph in phrases:
        words = ph.split()
        best_ph: Tuple[float, Optional[str]] = (1.0, None)
        for i in range(len(words)):
            for j in range(i + 1, len(words) + 1):
                span = " ".join(words[i:j])
                n = _norm(span)
                if len(n) < 3:
                    continue
                cer = _lev(n, c) / max(1, len(n))
                if cer < best_ph[0]:
                    best_ph = (cer, span)
        per_phrase.append(best_ph)
    if not per_phrase:
        return None, 1.0, 1.0
    order = sorted(range(len(per_phrase)), key=lambda k: per_phrase[k][0])
    cer, span = per_phrase[order[0]]
    runner = per_phrase[order[1]][0] if len(order) > 1 else 1.0
    return span, cer, runner


def harvest_image(
    engine,
    img: np.ndarray,
    phrases: List[str],
    tag: str,
    out_dir: str,
    labels: dict,
    stats: dict,
    max_cer: float = 0.45,
    margin_accept: Optional[Tuple[float, float]] = None,
) -> None:
    """Run the serving engine on one image, re-warp every detected quad
    exactly as recognize saw it, and keep crops whose decode aligns to a
    GT phrase span. Appends to ``labels``/``stats`` and writes PNGs.

    ``margin_accept=(loose_cer, min_margin)`` additionally keeps crops whose
    best alignment is worse than ``max_cer`` but still unambiguous: CER <=
    loose_cer and the runner-up phrase is at least ``min_margin`` worse.
    Use only where the phrase list is per-page (synthetic harvests)."""
    import torch

    from bbocr_tpu_torch.io import encode_png
    from bbocr_tpu_torch.runtime import bucketing
    from bbocr_tpu_torch.runtime.engine import _host_resize, _to_gray_u8
    from bbocr_tpu_torch.runtime.rectify import quad_to_rect_homography, warp_crops

    results = engine.readtext(img)
    stats["crops_seen"] += len(results)
    g = _to_gray_u8(img)
    canvas = bucketing.pick_canvas(g.shape[0], g.shape[1], engine.config.canvases)
    scale, oh, ow = bucketing.letterbox_params(g.shape[0], g.shape[1], canvas)
    batch = np.zeros((1, canvas.height, canvas.width), np.uint8)
    batch[0, :oh, :ow] = _host_resize(g, oh, ow)
    dev = torch.from_numpy(batch).to(engine.device).to(torch.float32)
    for k, (quad, text, conf) in enumerate(results):
        label, cer, runner = best_span_with_margin(text, phrases)
        if label is None:
            continue
        if cer > max_cer:
            if margin_accept is None:
                continue
            loose_cer, min_margin = margin_accept
            if cer > loose_cer or (runner - cer) < min_margin:
                continue
        q = np.asarray(quad, np.float32) * scale
        true_w, bucket_w = bucketing.crop_width_for_quad(q, engine.config.width_buckets)
        homo = np.asarray(quad_to_rect_homography(q, true_w), np.float32)
        crop = warp_crops(
            dev,
            torch.from_numpy(homo[None]).to(engine.device),
            torch.zeros(1, dtype=torch.int64, device=engine.device),
            torch.tensor([true_w], device=engine.device),
            bucket_w,
        ).cpu().numpy()[0, :, :true_w]
        name = f"{tag}_{k:02d}.png"
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(encode_png(np.clip(crop, 0, 255).astype(np.uint8)))
        labels[name] = {
            "label": label,
            "decode": text,
            "align_cer": round(cer, 3),
            "align_margin": round(runner - cer, 3),
            "conf": round(float(conf), 3),
        }
        stats["crops_kept"] += 1


def harvest_corpus(
    engine,
    out_dir: str,
    books_filter: str = "",
    max_cer: float = 0.45,
    data_dir: str = "data/real",
    margin_accept: Optional[Tuple[float, float]] = None,
) -> dict:
    """``harvest``'s loop over ``ground_truth.json`` with a given engine:
    each book's photos (turned with ``np.rot90(img, -1)`` where marked
    sideways) through ``harvest_image``, then ``labels.json``."""
    from bbocr_tpu_torch.io import imread_gray

    with open(os.path.join(data_dir, "ground_truth.json")) as f:
        gt = json.load(f)["books"]
    os.makedirs(out_dir, exist_ok=True)
    labels: dict = {}
    stats = {"books": 0, "crops_seen": 0, "crops_kept": 0}
    for book_id, entry in sorted(gt.items()):
        if books_filter and books_filter not in book_id:
            continue
        phrases = [p for p in entry.get("phrases", []) if p.strip()]
        if not phrases:
            continue
        stats["books"] += 1
        base = os.path.join(data_dir, book_id.split("/")[0])
        img_dir = (
            os.path.join(data_dir, os.path.dirname(book_id))
            if "/" in book_id
            else base
        )
        for img_name, sideways in zip(entry["images"], entry.get("sideways", [])):
            path = os.path.join(img_dir, img_name)
            if not os.path.exists(path):
                path = os.path.join(data_dir, book_id, img_name)
            if not os.path.exists(path):
                continue
            img = imread_gray(path)
            if sideways:
                img = np.rot90(img, -1).copy()
            tag = f"{book_id.replace('/', '_')}_{os.path.splitext(img_name)[0]}"
            harvest_image(
                engine, img, phrases, tag, out_dir, labels, stats, max_cer,
                margin_accept=margin_accept,
            )
    with open(os.path.join(out_dir, "labels.json"), "w") as f:
        json.dump(labels, f, indent=1, ensure_ascii=False)
    return stats


def harvest(
    craft: str,
    crnn: str,
    out_dir: str,
    books_filter: str = "",
    max_cer: float = 0.45,
    data_dir: str = "data/real",
    margin_accept: Optional[Tuple[float, float]] = None,
    device="cuda",
) -> dict:
    """The corpus harvest with an engine from the checkpoints in its
    default configuration (bfloat16), as the JAX tool builds it."""
    from bbocr_tpu_torch.runtime.engine import OCREngine

    engine = OCREngine.from_checkpoint(craft, crnn, device=device)
    return harvest_corpus(engine, out_dir, books_filter, max_cer, data_dir, margin_accept)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--craft", default="checkpoints/craft.npz")
    p.add_argument("--crnn", default="checkpoints/crnn.npz")
    p.add_argument("--out", default="data/real_crops")
    p.add_argument("--books", default="", help="substring filter on book id")
    p.add_argument("--max-cer", type=float, default=0.45)
    p.add_argument("--data-dir", default="data/real")
    p.add_argument(
        "--margin", default="",
        help="'loose_cer,min_margin': additionally keep hard decodes whose "
             "best phrase beats the runner-up by min_margin (see "
             "harvest_image.margin_accept)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    margin = None
    if args.margin:
        loose, min_m = (float(x) for x in args.margin.split(","))
        margin = (loose, min_m)
    stats = harvest(
        args.craft, args.crnn, args.out,
        books_filter=args.books, max_cer=args.max_cer, data_dir=args.data_dir,
        margin_accept=margin, device=args.device,
    )
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
