"""Image ops mirroring the reference's OpenCV/PIL semantics, on tensors.

Images are float32 tensors in the [0, 255] domain; grayscale images have
shape (..., H, W), color images (..., H, W, 3) in RGB order.
"""

from bbocr_tpu_torch.ops.color import quantize_u8, rgb_to_grayscale
from bbocr_tpu_torch.ops.filters import (
    gaussian_blur,
    gaussian_kernel_1d,
    pil_gaussian_kernel_1d,
    separable_filter2d,
    unsharp_mask,
)
from bbocr_tpu_torch.ops.histogram import clahe
from bbocr_tpu_torch.ops.pil_enhance import adjust_brightness, adjust_contrast, rounded_mean
from bbocr_tpu_torch.ops.resize import pil_bilinear_resize_u8, resize_bicubic

__all__ = [
    "quantize_u8",
    "rgb_to_grayscale",
    "gaussian_blur",
    "gaussian_kernel_1d",
    "pil_gaussian_kernel_1d",
    "separable_filter2d",
    "unsharp_mask",
    "clahe",
    "adjust_brightness",
    "adjust_contrast",
    "rounded_mean",
    "pil_bilinear_resize_u8",
    "resize_bicubic",
]
