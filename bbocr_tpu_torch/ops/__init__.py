"""Image ops mirroring the reference's OpenCV/PIL semantics, on tensors.

Images are float32 tensors in the [0, 255] domain; grayscale images have
shape (..., H, W), color images (..., H, W, 3) in RGB order.
"""

from bbocr_tpu_torch.ops.color import quantize_u8, rgb_to_grayscale
from bbocr_tpu_torch.ops.filters import (
    box_blur,
    gaussian_blur,
    gaussian_kernel_1d,
    pil_gaussian_kernel_1d,
    separable_filter2d,
    sobel_magnitude_u8,
    unsharp_mask,
)
from bbocr_tpu_torch.ops.histogram import clahe, equalize_hist, otsu_threshold, otsu_threshold_value
from bbocr_tpu_torch.ops.morphology import close as morph_close
from bbocr_tpu_torch.ops.morphology import dilate, erode
from bbocr_tpu_torch.ops.morphology import open_ as morph_open
from bbocr_tpu_torch.ops.pil_enhance import adjust_brightness, adjust_contrast, rounded_mean
from bbocr_tpu_torch.ops.resize import pil_bilinear_resize_u8, resize_bicubic, resize_bilinear
from bbocr_tpu_torch.ops.threshold import adaptive_threshold

__all__ = [
    "quantize_u8",
    "rgb_to_grayscale",
    "box_blur",
    "gaussian_blur",
    "gaussian_kernel_1d",
    "pil_gaussian_kernel_1d",
    "separable_filter2d",
    "sobel_magnitude_u8",
    "unsharp_mask",
    "clahe",
    "equalize_hist",
    "otsu_threshold",
    "otsu_threshold_value",
    "erode",
    "dilate",
    "morph_open",
    "morph_close",
    "adjust_brightness",
    "adjust_contrast",
    "rounded_mean",
    "pil_bilinear_resize_u8",
    "resize_bicubic",
    "resize_bilinear",
    "adaptive_threshold",
]
