"""The canonical book-cover preprocessing chain.

Counterpart of ``bbocr_tpu/preprocess/chain.py``. Reference recipe:

    grayscale -> resize x1.5 (bicubic) -> GaussianBlur(3x3, sigma=3)
    -> PIL Contrast(1.9) -> PIL Brightness(1.2) -> CLAHE(2.5, 8x8)
    -> UnsharpMask(radius=1.0, percent=30, threshold=3)

It runs as ``_chain_gray_pallas`` does: the blur, the fused contrast +
brightness and the unsharp mask are one kernel each
(``bbocr_tpu_torch.kernels``), CLAHE and the matmul resize are plain
PyTorch, and the per-image mean for the contrast step is taken between
kernels from an exact integer sum. On a CPU tensor each kernel wrapper
runs its plain version, so the CPU chain is the plain chain
(``_chain_gray``). ``_preprocess(..., PLAIN_OPS)`` calls the plain versions
on any device, which is how the kernels are held against them end to end.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from bbocr_tpu_torch import kernels
from bbocr_tpu_torch.ops import clahe, quantize_u8, resize_bicubic, rgb_to_grayscale, rounded_mean

BOOK_COVER_STEPS = (
    "original",
    "grayscale",
    "resize(scale_factor=1.5)",
    "denoise(strength=3)",
    "increase_contrast(factor=1.9)",
    "increase_brightness(factor=1.2)",
    "clahe(clip_limit=2.5)",
    "sharpen(amount=0.3)",
)


# The chain's three kernel steps: (blur, enhance, unsharp).
KERNEL_OPS = (kernels.blur3_u8, kernels.enhance_u8, kernels.unsharp_u8)
PLAIN_OPS = (kernels.blur3_u8_plain, kernels.enhance_u8_plain, kernels.unsharp_u8_plain)


def _chain_gray(x: torch.Tensor, out_h: int, out_w: int, ops=KERNEL_OPS) -> torch.Tensor:
    """(N, H, W) grayscale [0,255] -> preprocessed (N, out_h, out_w)."""
    blur, enhance, unsharp = ops
    x = quantize_u8(x)
    x = resize_bicubic(x, out_h, out_w).contiguous()
    x = blur(x, 3.0)
    x = enhance(x, rounded_mean(x), 1.9, 1.2)
    x = clahe(x, 2.5, (8, 8)).contiguous()
    return unsharp(x, 30, 3, 1.0)


def _preprocess(img, scale: float, device, ops) -> torch.Tensor:
    if not torch.is_tensor(img):
        img = torch.from_numpy(np.array(img, dtype=np.float32))
    arr = img.to(device=device, dtype=torch.float32)
    h, w = arr.shape[0], arr.shape[1]
    if arr.ndim == 3:
        arr = rgb_to_grayscale(arr)
    return _chain_gray(arr[None], int(h * scale), int(w * scale), ops)[0]


def preprocess_for_book_cover(img, scale: float = 1.5, device="cuda") -> Tuple[torch.Tensor, List[str]]:
    """Single image. ``img``: (H, W) gray or (H, W, 3) RGB in [0,255], a
    numpy array or a tensor. Returns ``(preprocessed, steps_applied)``:
    ``preprocessed`` is an (int(H*scale), int(W*scale)) float32 tensor on
    ``device``."""
    return _preprocess(img, scale, device, KERNEL_OPS), list(BOOK_COVER_STEPS)
