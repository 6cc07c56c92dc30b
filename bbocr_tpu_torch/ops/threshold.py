"""cv2.adaptiveThreshold (MEAN_C and GAUSSIAN_C), on tensors.

Counterpart of ``bbocr_tpu/ops/threshold.py``: the local mean is taken
with BORDER_REPLICATE and rounded to uint8; THRESH_BINARY keeps
``src > mean - C`` (strict), THRESH_BINARY_INV its complement.
"""

from __future__ import annotations

import torch

from bbocr_tpu_torch.ops.filters import box_blur, gaussian_kernel_1d, separable_filter2d


def adaptive_threshold(
    img: torch.Tensor,
    maxval: float = 255.0,
    method: str = "mean",
    block_size: int = 11,
    c: float = 2.0,
    inverse: bool = False,
) -> torch.Tensor:
    src = torch.clamp(torch.round(img), 0, 255)
    if method == "mean":
        mean = box_blur(src, block_size, border="replicate", normalize=True)
    elif method == "gaussian":
        taps = gaussian_kernel_1d(block_size, -1.0)  # cv2's default sigma rule
        mean = separable_filter2d(src, taps, taps, border="replicate")
    else:
        raise ValueError(f"unknown adaptive threshold method: {method}")
    mean = torch.clamp(torch.round(mean), 0, 255)
    above = src > mean - c
    mask = ~above if inverse else above
    return torch.where(mask, maxval, 0.0).to(torch.float32)
