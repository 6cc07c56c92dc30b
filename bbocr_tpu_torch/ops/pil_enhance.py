"""PIL.ImageEnhance parity ops on grayscale tensors.

Counterpart of ``bbocr_tpu/ops/pil_enhance.py``. PIL semantics:
Contrast blends with a solid image of the rounded mean, Brightness with
black; ``blend(a, b, f) = a + f * (b - a)``, rounded half up, clipped.
"""

from __future__ import annotations

import torch

from bbocr_tpu_torch.ops.color import quantize_u8


def _blend(degenerate: torch.Tensor, img: torch.Tensor, factor: float) -> torch.Tensor:
    out = degenerate + factor * (img - degenerate)
    return torch.clamp(torch.floor(out + 0.5), 0.0, 255.0)


# A float32 sum of this many values in [0, 255] is a whole number below
# 2**24, so it is exact whatever the order of its additions.
_EXACT_COLS = (1 << 24) // 255


def rounded_mean(img: torch.Tensor) -> torch.Tensor:
    """PIL's ``int(ImageStat.mean + 0.5)`` per image over the last two axes.

    ``img`` holds uint8 values. Row sums are taken in float32 over chunks of
    at most ``_EXACT_COLS`` columns, which is exact, and added up in float64,
    exact below 2**53; no widened copy of the image is made. The total is
    divided in float64 as PIL does in Python.
    """
    h, w = img.shape[-2], img.shape[-1]
    total = img[..., :_EXACT_COLS].sum(dim=-1).to(torch.float64).sum(dim=-1)
    for c in range(_EXACT_COLS, w, _EXACT_COLS):
        total = total + img[..., c : c + _EXACT_COLS].sum(dim=-1).to(torch.float64).sum(dim=-1)
    return torch.floor(total / (h * w) + 0.5).to(torch.float32)


def adjust_contrast(img: torch.Tensor, factor: float) -> torch.Tensor:
    """ImageEnhance.Contrast(img).enhance(factor) on (..., H, W) grayscale."""
    x = quantize_u8(img)
    mean = rounded_mean(x)[..., None, None]
    return _blend(mean, x, factor)


def adjust_brightness(img: torch.Tensor, factor: float) -> torch.Tensor:
    """ImageEnhance.Brightness(img).enhance(factor)."""
    return _blend(torch.zeros_like(img), quantize_u8(img), factor)
