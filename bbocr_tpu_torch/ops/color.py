"""Color conversions (cv2.cvtColor parity), on tensors.

Counterpart of ``bbocr_tpu/ops/color.py``.
"""

from __future__ import annotations

import torch

# BT.601 luma weights used by OpenCV for *2GRAY conversions (R, G, B order).
_LUMA_RGB = (0.299, 0.587, 0.114)


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even and clip to [0, 255], staying float32.

    Models the uint8 store the reference performs after every OpenCV/PIL
    step. ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    return torch.clamp(torch.round(x), 0.0, 255.0)


def rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) RGB float [0,255] -> (..., H, W) grayscale, quantized."""
    r = img[..., 0]
    g = img[..., 1]
    b = img[..., 2]
    y = _LUMA_RGB[0] * r + _LUMA_RGB[1] * g + _LUMA_RGB[2] * b
    return quantize_u8(y)
