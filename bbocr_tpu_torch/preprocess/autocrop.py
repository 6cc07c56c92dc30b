"""Crop rectangles for OCR.

Counterpart of ``bbocr_tpu/preprocess/autocrop.py``; only the central edge
crop is ported so far (auto-crop is a later ROADMAP.md item).
"""

from __future__ import annotations

from typing import Optional, Tuple


def central_edge_crop(shape: Tuple[int, int], percent: float) -> Optional[Tuple[int, int, int, int]]:
    """Centered crop rectangle (x0, y0, x1, y1) removing ``percent`` from
    each edge; None when the crop would keep less than max(16 px, 20 %) of
    a dimension."""
    if percent <= 0.0:
        return None
    h, w = shape
    mx = int(round(w * (percent / 100.0)))
    my = int(round(h * (percent / 100.0)))
    x0, y0 = max(0, mx), max(0, my)
    x1, y1 = min(w, w - mx), min(h, h - my)
    if x1 - x0 < max(16, w * 0.2) or y1 - y0 < max(16, h * 0.2):
        return None
    return x0, y0, x1, y1
