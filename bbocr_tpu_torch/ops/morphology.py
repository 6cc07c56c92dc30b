"""cv2.erode / cv2.dilate / cv2.morphologyEx with rectangular kernels, as
windowed min/max pooling.

Counterpart of ``bbocr_tpu/ops/morphology.py`` (``lax.reduce_window``).
The window of pixel y covers rows y - k // 2 .. y + k - 1 - k // 2 (cv2's
anchor at k // 2; for an even k the window is not centered), and the same
for columns; cv2's default border value (+inf for erode, -inf for dilate)
makes the border neutral. ``F.max_pool2d`` pads symmetrically and only with
-inf, so the asymmetric padding is applied here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _window_max(img: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Max over a (kh, kw) window anchored at (kh // 2, kw // 2), on the last
    two axes, with a neutral border."""
    pad = (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2)
    lead = img.shape[:-2]
    x = img.reshape((-1, 1) + img.shape[-2:])
    x = F.pad(x, pad, value=float("-inf"))
    return F.max_pool2d(x, (kh, kw), stride=1).reshape(lead + img.shape[-2:])


def erode(img: torch.Tensor, ksize: tuple, iterations: int = 1) -> torch.Tensor:
    """cv2.erode with a (kw, kh) rectangle; ``ksize`` is (kw, kh) as in cv2."""
    kw, kh = ksize
    out = img
    for _ in range(iterations):
        out = -_window_max(-out, kh, kw)
    return out


def dilate(img: torch.Tensor, ksize: tuple, iterations: int = 1) -> torch.Tensor:
    """cv2.dilate with a (kw, kh) rectangle."""
    kw, kh = ksize
    out = img
    for _ in range(iterations):
        out = _window_max(out, kh, kw)
    return out


def close(img: torch.Tensor, ksize: tuple, iterations: int = 1) -> torch.Tensor:
    """cv2.morphologyEx(MORPH_CLOSE): dilate ``iterations`` times, then erode."""
    return erode(dilate(img, ksize, iterations), ksize, iterations)


def open_(img: torch.Tensor, ksize: tuple, iterations: int = 1) -> torch.Tensor:
    """cv2.morphologyEx(MORPH_OPEN): erode ``iterations`` times, then dilate."""
    return dilate(erode(img, ksize, iterations), ksize, iterations)
