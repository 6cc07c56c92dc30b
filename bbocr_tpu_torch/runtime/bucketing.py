"""Static-shape bucketing policies.

Counterpart of ``bbocr_tpu/runtime/bucketing.py`` (same menus and rules):
detector canvases, recognizer width buckets and crop-count capacities
bound the number of distinct shapes the engine runs, so per-shape costs
(cuDNN algorithm choice, allocator blocks) are paid once per shape while
padding waste stays low.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from bbocr_tpu_torch.models.crnn import INPUT_HEIGHT

# Recognizer width buckets (pixels). T = w/4 - 1 CTC frames.
DEFAULT_WIDTH_BUCKETS: Tuple[int, ...] = (64, 128, 256, 384, 512)

# Crop-count capacities per recognizer batch: next value >= n.
DEFAULT_CAPACITIES: Tuple[int, ...] = (8, 32, 128, 384)


def pick_bucket(value: float, buckets: Sequence[int]) -> int:
    """Smallest bucket >= value, else the largest bucket."""
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def pad_count(n: int, capacities: Sequence[int] = DEFAULT_CAPACITIES) -> int:
    for c in capacities:
        if n <= c:
            return c
    return ((n + capacities[-1] - 1) // capacities[-1]) * capacities[-1]


@dataclass(frozen=True)
class CanvasSpec:
    """Detector input canvas (static, multiples of 32)."""

    height: int
    width: int


DEFAULT_CANVASES: Tuple[CanvasSpec, ...] = (
    CanvasSpec(704, 512),    # portrait book photos (cover/title/copyright)
    CanvasSpec(512, 704),    # landscape
    CanvasSpec(512, 512),    # square-ish
    CanvasSpec(1184, 864),   # mid portrait
    CanvasSpec(864, 1184),   # mid landscape
    CanvasSpec(1408, 1024),  # hi-res portrait (camera photos of dense pages)
    CanvasSpec(1024, 1408),  # hi-res landscape
)

# XL tier, added by BB_OCR_CANVAS_XL=1.
XL_CANVASES: Tuple[CanvasSpec, ...] = (
    CanvasSpec(1792, 1312),
    CanvasSpec(1312, 1792),
)


def default_canvases() -> Tuple[CanvasSpec, ...]:
    """Canvas menu honoring BB_OCR_CANVAS_XL at call time."""
    if os.environ.get("BB_OCR_CANVAS_XL", "0") not in ("", "0"):
        return DEFAULT_CANVASES + XL_CANVASES
    return DEFAULT_CANVASES


def detail_scale() -> float:
    """Least letterbox scale before a larger canvas is chosen
    (BB_OCR_DETAIL_SCALE, read at call time)."""
    return float(os.environ.get("BB_OCR_DETAIL_SCALE", "0.55"))


def pick_canvas(h: int, w: int, canvases: Sequence[CanvasSpec] = DEFAULT_CANVASES) -> CanvasSpec:
    """Choose a canvas by aspect ratio AND resolution.

    Among canvases that keep the letterbox scale >= detail_scale(), pick the
    best aspect match, compared in 0.08-wide buckets, ties -> the smaller
    canvas. If none is large enough, pick the one preserving the most detail.
    """
    aspect = w / max(h, 1)

    def fit(c: CanvasSpec) -> float:
        return min(c.height / h, c.width / w)

    keep = [c for c in canvases if fit(c) >= detail_scale()]
    if keep:
        return min(
            keep,
            key=lambda c: (
                int(abs(c.width / c.height - aspect) / 0.08),
                c.height * c.width,
            ),
        )
    return max(canvases, key=lambda c: (fit(c), -abs(c.width / c.height - aspect)))


def letterbox_params(h: int, w: int, canvas: CanvasSpec) -> Tuple[float, int, int]:
    """(scale, out_h, out_w): aspect-preserving fit into the canvas."""
    scale = min(canvas.height / h, canvas.width / w)
    return scale, int(round(h * scale)), int(round(w * scale))


def crop_width_for_quad(quad: np.ndarray, buckets: Sequence[int] = DEFAULT_WIDTH_BUCKETS) -> Tuple[int, int]:
    """(true_width, bucket_width) for a quad rectified to height 32."""
    w_top = np.linalg.norm(quad[1] - quad[0])
    w_bot = np.linalg.norm(quad[2] - quad[3])
    h_l = np.linalg.norm(quad[3] - quad[0])
    h_r = np.linalg.norm(quad[2] - quad[1])
    w_src = max(w_top, w_bot)
    h_src = max(h_l, h_r)
    aspect = w_src / max(h_src, 1e-6)
    true_w = int(round(INPUT_HEIGHT * aspect))
    true_w = max(8, min(true_w, buckets[-1]))
    return true_w, pick_bucket(true_w, buckets)
