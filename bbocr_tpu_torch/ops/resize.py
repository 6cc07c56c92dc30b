"""Resize as two matrix products, cv2 INTER_CUBIC parity.

Counterpart of ``bbocr_tpu/ops/resize.py``: ``out = W_rows @ img @ W_cols^T``
with the (n_out, n_in) resampling matrices built in numpy (half-pixel
centers, cubic a = -0.75, edge clamping). The products are plain
``torch.matmul`` calls outside any kernel; in float32 they must not run in
TF32, which would cost the uint8 parity.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from bbocr_tpu_torch.ops.color import quantize_u8


def _cubic_weights(f: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution weights for taps at offsets (-1, 0, 1, 2).

    ``f`` is the fractional coordinate in [0, 1); returns shape (len(f), 4).
    Matches OpenCV's interpolateCubic (A = -0.75).
    """
    f = f.astype(np.float64)
    w = np.empty((f.size, 4), np.float64)
    w[:, 0] = ((a * (f + 1) - 5 * a) * (f + 1) + 8 * a) * (f + 1) - 4 * a
    w[:, 1] = ((a + 2) * f - (a + 3)) * f * f + 1
    w[:, 2] = ((a + 2) * (1 - f) - (a + 3)) * (1 - f) * (1 - f) + 1
    w[:, 3] = 1.0 - w[:, 0] - w[:, 1] - w[:, 2]
    return w


@lru_cache(maxsize=None)
def _resample_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) cubic resampling matrix, cv2 half-pixel-center mapping."""
    scale = n_in / n_out
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    ix = np.floor(x).astype(np.int64)
    w = _cubic_weights(x - ix)
    mat = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    for t_idx, t in enumerate((-1, 0, 1, 2)):
        src = np.clip(ix + t, 0, n_in - 1)
        np.add.at(mat, (rows, src), w[:, t_idx].astype(np.float32))
    return mat


def resize_bicubic(img: torch.Tensor, out_h: int, out_w: int, quantize: bool = True) -> torch.Tensor:
    """cv2.resize INTER_CUBIC on the last two axes of a grayscale image."""
    if img.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "resize needs full float32 products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )
    h, w = img.shape[-2], img.shape[-1]
    wr = torch.from_numpy(_resample_matrix(out_h, h)).to(img.device)
    wc = torch.from_numpy(_resample_matrix(out_w, w)).to(img.device)
    out = torch.matmul(torch.matmul(wr, img), wc.T)
    return quantize_u8(out) if quantize else out
