"""Separable filters (cv2 + PIL parity) on the last two axes, as tensors.

Counterpart of ``bbocr_tpu/ops/filters.py``. These are also the plain
versions of the preprocessing kernels in ``bbocr_tpu_torch.kernels``: the
kernels must agree with them bit for bit, so the arithmetic here is fixed:
a vertical then a horizontal correlation in float32, taps summed in index
order, each tap a float32 multiply followed by a float32 add.

Border modes: "reflect101" (cv2 BORDER_REFLECT_101, numpy "reflect") and
"replicate" (cv2 BORDER_REPLICATE, numpy "edge").
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from bbocr_tpu_torch.ops.color import quantize_u8


def border_index(n: int, lo: int, hi: int, mode: str) -> np.ndarray:
    """Source index of each position of an axis padded by (lo, hi)."""
    idx = np.arange(-lo, n + hi)
    if mode == "replicate":
        return np.clip(idx, 0, n - 1)
    if mode != "reflect101":
        raise ValueError(f"unknown border mode: {mode}")
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def pad2d(img: torch.Tensor, top: int, bottom: int, left: int, right: int, mode: str) -> torch.Tensor:
    """Pad the last two axes with an OpenCV-style border mode."""
    h, w = img.shape[-2], img.shape[-1]
    rows = torch.from_numpy(border_index(h, top, bottom, mode)).to(img.device)
    cols = torch.from_numpy(border_index(w, left, right, mode)).to(img.device)
    return img.index_select(-2, rows).index_select(-1, cols)


def _correlate_axis(img: torch.Tensor, taps, axis: int, border: str) -> torch.Tensor:
    """1-D correlation along ``axis`` (-1 or -2) with static float taps."""
    k = len(taps)
    r_lo = (k - 1) // 2
    r_hi = k - 1 - r_lo
    if axis == -2:
        padded = pad2d(img, r_lo, r_hi, 0, 0, border)
    else:
        padded = pad2d(img, 0, 0, r_lo, r_hi, border)
    n = img.shape[axis]
    out = None
    for i, w in enumerate(taps):
        if w == 0.0:
            continue
        term = float(w) * padded.narrow(axis, i, n)
        out = term if out is None else out + term
    return out


def separable_filter2d(img: torch.Tensor, taps_y, taps_x, border: str = "reflect101") -> torch.Tensor:
    out = _correlate_axis(img, taps_y, -2, border)
    return _correlate_axis(out, taps_x, -1, border)


# cv2's fixed binomial kernels used when sigma <= 0 and ksize <= 7.
_SMALL_GAUSSIAN_TAB = {
    1: (1.0,),
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
}


@lru_cache(maxsize=None)
def gaussian_kernel_1d(ksize: int, sigma: float) -> tuple:
    """cv2.getGaussianKernel parity (including the sigma<=0 default rules)."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN_TAB:
        return _SMALL_GAUSSIAN_TAB[ksize]
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = (ksize - 1) * 0.5
    xs = np.arange(ksize, dtype=np.float64) - half
    w = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    w /= w.sum()
    return tuple(w.tolist())


def gaussian_blur(
    img: torch.Tensor, ksize: int, sigma: float, border: str = "reflect101", quantize: bool = True
) -> torch.Tensor:
    """cv2.GaussianBlur on the last two axes (square kernel)."""
    taps = gaussian_kernel_1d(ksize, sigma)
    out = separable_filter2d(img, taps, taps, border)
    return quantize_u8(out) if quantize else out


@lru_cache(maxsize=None)
def pil_gaussian_kernel_1d(radius: float, passes: int = 3) -> tuple:
    """Effective 1-D kernel of Pillow's GaussianBlur: ``passes`` extended
    box filters (Gwosdek et al., SSVM'11) auto-convolved into one kernel."""
    sigma2 = radius * radius / passes
    li = int((math.sqrt(12.0 * sigma2 + 1.0) - 1.0) / 2.0)
    denom = 2.0 * ((li + 1) ** 2 - sigma2)
    alpha = (2 * li + 1) * (sigma2 - li * (li + 1) / 3.0) / denom if denom != 0 else 0.0
    base = np.ones(2 * li + 3, np.float64)
    base[0] = base[-1] = alpha
    base /= base.sum()
    kern = base
    for _ in range(passes - 1):
        kern = np.convolve(kern, base)
    return tuple(kern.tolist())


def pil_gaussian_blur(img: torch.Tensor, radius: float, passes: int = 3) -> torch.Tensor:
    """PIL.ImageFilter.GaussianBlur approximation (float, edge-replicated)."""
    taps = pil_gaussian_kernel_1d(radius, passes)
    return separable_filter2d(img, taps, taps, border="replicate")


def unsharp_mask(
    img: torch.Tensor, radius: float = 1.0, percent: int = 30, threshold: int = 3
) -> torch.Tensor:
    """PIL.ImageFilter.UnsharpMask on grayscale [0,255] floats: where
    |in - blur| >= threshold, out = clip(in + (in - blur) * percent // 100)
    with C integer truncation."""
    blurred = quantize_u8(pil_gaussian_blur(img, radius))
    src = quantize_u8(img)
    diff = src - blurred
    scaled = diff * float(percent)
    adj = torch.sign(scaled) * torch.floor(torch.abs(scaled) / 100.0)
    out = torch.where(torch.abs(diff) >= threshold, src + adj, src)
    return quantize_u8(out)
