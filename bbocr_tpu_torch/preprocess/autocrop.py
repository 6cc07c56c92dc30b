"""Crop rectangles for OCR: the auto text-region crop and the central edge
crop.

Counterpart of ``bbocr_tpu/preprocess/autocrop.py``, the reference's crop
heuristic:

1. composite text mask = OR of adaptive-mean(35, 10, INV),
   adaptive-gauss(31, 5, INV), Otsu(INV) and a Sobel-gradient Otsu, on a
   lightly denoised, CLAHE(2.0)-equalized gray image;
2. two morphology variants (close x2 / open x1 / dilate x1 with rect
   kernels (9, 3) + (3, 3) + (11, 3) and (15, 5) + (3, 3) + (11, 3)),
   OR-merged;
3. connected components -> bounding boxes, area-filtered to [1e-4, 0.10] x
   the image area; their union, inflated if under 0.12 x the area; the
   margin; clamped to the image.

Steps 1 and 2 run as tensor ops on the image's device (``text_mask``);
step 3 labels the binary mask with the C++ labeler on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from bbocr_tpu_torch.native import connected_components
from bbocr_tpu_torch.ops import (
    adaptive_threshold,
    clahe,
    dilate,
    gaussian_blur,
    morph_close,
    morph_open,
    otsu_threshold,
    otsu_threshold_value,
    rgb_to_grayscale,
    sobel_magnitude_u8,
)


def text_mask(gray: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) gray in [0, 255] -> (morphed mask, composite mask), each
    {0, 1} float32 of the same shape."""
    g = gaussian_blur(gray, 3, 0.0)
    g = clahe(g, 2.0, (8, 8))
    thr_mean = adaptive_threshold(g, 255.0, "mean", 35, 10, inverse=True)
    thr_gaus = adaptive_threshold(g, 255.0, "gaussian", 31, 5, inverse=True)
    thr_otsu = otsu_threshold(g, 255.0, inverse=True)
    grad = sobel_magnitude_u8(g)
    thr_grad = torch.where(grad > otsu_threshold_value(grad), 255.0, 0.0)
    mask = torch.maximum(torch.maximum(thr_mean, thr_gaus), torch.maximum(thr_otsu, thr_grad))

    def morph_pass(src, kclose):
        closed = morph_close(src, kclose, 2)
        opened = morph_open(closed, (3, 3), 1)
        return dilate(opened, (11, 3), 1)

    merged = torch.maximum(morph_pass(mask, (9, 3)), morph_pass(mask, (15, 5)))
    return (merged > 0).to(torch.float32), (mask > 0).to(torch.float32)


def auto_crop_text_region(img, margin: int, device="cuda") -> Optional[Tuple[int, int, int, int]]:
    """The crop rectangle (x0, y0, x1, y1), or None when no crop applies.

    ``img``: (H, W) gray or (H, W, 3) RGB in [0, 255], a numpy array or a
    tensor; the mask is computed on ``device`` (a tensor's own device if it
    is one). The caller slices the image.
    """
    if torch.is_tensor(img):
        arr = img.to(torch.float32)
    else:
        arr = torch.from_numpy(np.asarray(img, np.float32)).to(device)
    gray = rgb_to_grayscale(arr) if arr.ndim == 3 else arr
    h, w = int(gray.shape[0]), int(gray.shape[1])
    merged, raw_mask = text_mask(gray)

    img_area = float(h * w)
    boxes = _component_boxes(merged.to(torch.uint8).cpu().numpy(), img_area, min_frac=0.0001, max_frac=0.10)
    if boxes.size == 0:
        # the reference falls back to the unmorphed mask with no area filter
        boxes = _component_boxes(raw_mask.to(torch.uint8).cpu().numpy(), img_area, 0.0, 1.1)
        if boxes.size == 0:
            return None

    x0 = int(boxes[:, 0].min())
    y0 = int(boxes[:, 1].min())
    x1 = int(boxes[:, 2].max()) + 1
    y1 = int(boxes[:, 3].max()) + 1

    area = float((x1 - x0) * (y1 - y0))
    if area < 0.12 * img_area:
        pad = int(0.03 * max(w, h))
        x0 = max(0, x0 - pad)
        y0 = max(0, y0 - pad)
        x1 = min(w, x1 + pad)
        y1 = min(h, y1 + pad)
    x0 = max(0, x0 - margin)
    y0 = max(0, y0 - margin)
    x1 = min(w, x1 + margin)
    y1 = min(h, y1 + margin)
    if x1 <= x0 or y1 <= y0:
        return None
    return x0, y0, x1, y1


def _component_boxes(mask: np.ndarray, img_area: float, min_frac: float, max_frac: float) -> np.ndarray:
    _, stats = connected_components(mask, connectivity=8)
    if stats.shape[0] == 0:
        return np.empty((0, 4))
    bw = stats[:, 2] - stats[:, 0] + 1
    bh = stats[:, 3] - stats[:, 1] + 1
    areas = bw * bh
    keep = (areas >= min_frac * img_area) & (areas <= max_frac * img_area)
    return stats[keep][:, :4]


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
