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


def rounded_mean(img: torch.Tensor) -> torch.Tensor:
    """PIL's ``int(ImageStat.mean + 0.5)`` per image over the last two axes.

    ``img`` holds uint8 values. The sum is taken in int64, so it is exact at
    any image size (a float32 sum of a 1312x1050 image is not), and divided
    in float64 as PIL does in Python.
    """
    total = img.to(torch.int64).sum(dim=(-2, -1))
    n = img.shape[-2] * img.shape[-1]
    return torch.floor(total.to(torch.float64) / n + 0.5).to(torch.float32)


def adjust_contrast(img: torch.Tensor, factor: float) -> torch.Tensor:
    """ImageEnhance.Contrast(img).enhance(factor) on (..., H, W) grayscale."""
    x = quantize_u8(img)
    mean = rounded_mean(x)[..., None, None]
    return _blend(mean, x, factor)


def adjust_brightness(img: torch.Tensor, factor: float) -> torch.Tensor:
    """ImageEnhance.Brightness(img).enhance(factor)."""
    return _blend(torch.zeros_like(img), quantize_u8(img), factor)
