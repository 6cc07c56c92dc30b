"""Orientation handling for hand-held book photos.

Counterpart of ``bbocr_tpu/runtime/orient.py``, in numpy: book photos are
mostly shot in camera-landscape with the book sideways, and the detector
does not read rotated lines, so the pipeline re-reads the photo at the
four right-angle rotations and keeps the most *confidently* read one.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def rotation_score(results) -> float:
    """How much *confident* text a readtext result list carries.

    Tuned offline against per-rotation dumps of the real corpus: summing
    len*conf over ALL results lets hundreds of low-confidence garbage
    fragments (texture false-positives) outvote a handful of clean reads
    at the true orientation. Gating on conf > 0.4 and len > 2 picked the
    best rotation on 12/14 dump images vs 9/14 ungated (mean recall
    regret 0.025 vs 0.067). Geometry-only scores (wide-quad area/count)
    measured far worse (6/14) — recognition confidence is the signal.
    """
    return sum(len(t) * c for _, t, c in results if c > 0.4 and len(t.strip()) > 2)


def _wordlike_mass(results) -> float:
    """Fallback orientation signal: total length of word-shaped reads.

    Distant small-text pages (photos/8,10,13,19 in the corpus) decode
    with near-zero confidence even at the true orientation — the gated
    score above is 0 for every rotation and the chooser degenerates to
    "first k wins". But only the true orientation produces long mostly-
    alphabetic reads ('to four of ny frienas and coueogles'); wrong
    rotations yield single letters and digit junk. Length of reads with
    >= 4 chars and >= 60% letters separates them without trusting the
    miscalibrated confidences.
    """
    total = 0.0
    for _, t, _ in results:
        t = t.strip()
        if len(t) < 4:
            continue
        alpha = sum(ch.isalpha() for ch in t)
        if alpha / len(t) >= 0.6:
            total += len(t)
    return total


def zoom_reread(
    engine,
    img: np.ndarray,
    results: List,
    *,
    max_area_frac: float = 0.40,
    margin_frac: float = 0.06,
) -> Tuple[List, bool]:
    """Detection-guided zoom: re-read the text region at higher scale.

    Distant/small pages (the reference corpus's hand-held copyright pages:
    a 2400px frame whose text block is ~1/4 of it) letterbox the glyphs
    below the recognizer's floor — detection localizes the text but every
    read is garbage. When the union box of the first-pass detections
    covers <= ``max_area_frac`` of the frame, crop the ORIGINAL image to
    that box (+margin) and re-read: the crop letterboxes near 1:1 on the
    same static canvas menu (no new compiled shapes). The zoomed result
    replaces the first pass only when it carries more confident text
    (:func:`rotation_score`), with boxes shifted back to the full frame.

    TPU-first equivalent of the reference's auto-crop-then-OCR
    (``enhanced_extractor.py:239-372``, applied before ``readtext`` at
    ``:520``) — but guided by the detector's own quads instead of host
    threshold/morphology heuristics, so background clutter (hands,
    carpet, boxes in the corpus photos) cannot inflate the crop.
    """
    if not results:
        return results, False
    # Crop from CREDIBLE quads only: scattered background false positives
    # (hands/carpet/boxes read as single letters) otherwise stretch the
    # union box over the whole frame and the zoom never triggers.
    credible = []
    for b, t, c in results:
        t = t.strip()
        alpha = sum(ch.isalpha() for ch in t)
        if (len(t) >= 4 and alpha / max(len(t), 1) >= 0.5) or (
            c >= 0.35 and len(t) >= 2
        ):
            credible.append(b)
    if not credible:
        # no word-shaped read anywhere: zoom on the largest detection
        # (a fused paragraph block decodes as junk but its quad is real)
        credible = [
            max(
                (np.asarray(r[0], np.float32) for r in results),
                key=lambda q: float(
                    (q[:, 0].max() - q[:, 0].min())
                    * (q[:, 1].max() - q[:, 1].min())
                ),
            )
        ]
    pts = np.concatenate([np.asarray(b, np.float32) for b in credible])
    h, w = img.shape[:2]
    x0, y0 = pts.min(axis=0)
    x1, y1 = pts.max(axis=0)
    bw, bh = x1 - x0, y1 - y0
    if bw <= 8 or bh <= 8 or (bw * bh) / float(w * h) > max_area_frac:
        return results, False
    mx, my = bw * margin_frac, bh * margin_frac
    cx0 = int(max(0, np.floor(x0 - mx)))
    cy0 = int(max(0, np.floor(y0 - my)))
    cx1 = int(min(w, np.ceil(x1 + mx)))
    cy1 = int(min(h, np.ceil(y1 + my)))
    crop = np.ascontiguousarray(img[cy0:cy1, cx0:cx1])
    zoomed = engine.readtext(crop)
    # low-conf regime: both passes can score 0 on the gated metric, so
    # break ties on word-shaped mass (same signal as the rotation chooser)
    def _metric(res):
        return rotation_score(res) + 0.01 * _wordlike_mass(res)

    if _metric(zoomed) <= _metric(results):
        return results, False
    off = np.array([cx0, cy0], np.float32)
    return [(np.asarray(b, np.float32) + off, t, c) for b, t, c in zoomed], True


def _auto_zoom_enabled() -> bool:
    return os.environ.get("BB_OCR_AUTO_ZOOM", "0").lower() not in (
        "0", "", "false",
    )


def read_with_rotations(
    engine, img: np.ndarray, rotations=(0, 1, 2, 3), reread_conf_ths: float = 0.0
) -> Tuple[List, int]:
    """OCR under each np.rot90 k, keep the best by rotation_score.

    Returns (results, chosen_k); result boxes are in the ROTATED image's
    coordinate frame. ``reread_conf_ths`` > 0 applies the engine's
    low-confidence full-resolution re-read to the winning rotation only (the
    re-read needs the matching image frame, hence here and not per k).
    With ``BB_OCR_AUTO_ZOOM=1``, the winning rotation additionally gets a
    detection-guided :func:`zoom_reread` pass.
    """
    best, best_score, best_k = [], (-1.0, -1.0), 0
    for k in rotations:
        rot = np.rot90(img, k) if k else img
        res = engine.readtext(np.ascontiguousarray(rot))
        # primary: confident text mass; tiebreak (the all-zero low-conf
        # regime of distant small-text pages): word-shaped read length
        score = (rotation_score(res), _wordlike_mass(res))
        if score > best_score:
            best, best_score, best_k = res, score, k
    rot = np.rot90(img, best_k) if best_k else img
    if _auto_zoom_enabled() and best:
        best, _ = zoom_reread(engine, np.ascontiguousarray(rot), best)
    if reread_conf_ths > 0 and best and hasattr(engine, "reread_low_conf"):
        best = engine.reread_low_conf(np.ascontiguousarray(rot), best, conf_ths=reread_conf_ths)
    return best, best_k
