"""Resize as two matrix products, cv2 INTER_CUBIC and INTER_LINEAR parity;
and Pillow's BILINEAR resample of a uint8 image, in numpy.

Counterpart of ``bbocr_tpu/ops/resize.py``: ``out = W_rows @ img @ W_cols^T``
with the (n_out, n_in) resampling matrices built in numpy (half-pixel
centers, cubic a = -0.75 or linear, edge clamping). The products are plain
``torch.matmul`` calls outside any kernel; in float32 they must not run in
TF32, which would cost the uint8 parity. ``pil_bilinear_resize_u8`` is the
extractor's downscale of photos over its size limit (host work, as the
JAX extractor's Pillow call is).
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
def _resample_matrix(n_out: int, n_in: int, kind: str = "cubic") -> np.ndarray:
    """(n_out, n_in) cubic or linear resampling matrix, cv2 half-pixel-center
    mapping."""
    scale = n_in / n_out
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    ix = np.floor(x).astype(np.int64)
    f = x - ix
    if kind == "cubic":
        w, taps = _cubic_weights(f), (-1, 0, 1, 2)
    elif kind == "linear":
        w, taps = np.stack([1.0 - f, f], axis=1), (0, 1)
    else:
        raise ValueError(f"unknown resize kind: {kind}")
    mat = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    for t_idx, t in enumerate(taps):
        src = np.clip(ix + t, 0, n_in - 1)
        np.add.at(mat, (rows, src), w[:, t_idx].astype(np.float32))
    return mat


def _resize2d(img: torch.Tensor, out_h: int, out_w: int, kind: str, quantize: bool) -> torch.Tensor:
    if img.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "resize needs full float32 products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )
    h, w = img.shape[-2], img.shape[-1]
    wr = torch.from_numpy(_resample_matrix(out_h, h, kind)).to(img.device)
    wc = torch.from_numpy(_resample_matrix(out_w, w, kind)).to(img.device)
    out = torch.matmul(torch.matmul(wr, img), wc.T)
    return quantize_u8(out) if quantize else out


def resize_bicubic(img: torch.Tensor, out_h: int, out_w: int, quantize: bool = True) -> torch.Tensor:
    """cv2.resize INTER_CUBIC on the last two axes of a grayscale image."""
    return _resize2d(img, out_h, out_w, "cubic", quantize)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int, quantize: bool = False) -> torch.Tensor:
    """cv2.resize INTER_LINEAR (upscaling case) on the last two axes.
    Counterpart of ``bbocr_tpu/ops/resize.py::resize_bilinear``."""
    return _resize2d(img, out_h, out_w, "linear", quantize)


# Pillow's Resample.c: fixed-point coefficients for 8-bit images.
_PIL_PRECISION_BITS = 32 - 8 - 2


def _pil_bilinear_coeffs(in_size: int, out_size: int):
    """``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the BILINEAR
    filter (support 1): (first source index, int32 weights (out, ksize))."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = np.maximum(1.0 - np.abs((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale)), 0.0)
    w[taps[None, :] >= xmax[:, None]] = 0.0
    total = np.zeros(out_size)
    for k in range(ksize):  # summed in tap order, as the C loop does
        total += w[:, k]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = np.trunc(0.5 + w * (1 << _PIL_PRECISION_BITS)).astype(np.int64)
    return xmin, fixed


def _pil_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit resampling pass along ``axis`` (0 rows, 1 columns)."""
    xmin, k = _pil_bilinear_coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img.astype(np.int64), axis, 0)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :], src.shape[0] - 1)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PIL_PRECISION_BITS - 1), np.int64)
    for t in range(k.shape[1]):
        acc += src[idx[:, t]] * k[:, t].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_bilinear_resize_u8(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``Image.fromarray(img).resize((out_w, out_h), Image.BILINEAR)`` for a
    (H, W) uint8 image, bit for bit, in numpy.

    Pillow's ``Resample.c``: the triangle filter's support widens with the
    downscale factor, sample centres at ``(x + 0.5) * scale``, weights
    normalised and turned into 22-bit fixed point; the horizontal pass runs
    first, each pass rounds and clips to uint8, and a pass whose size does
    not change is skipped.
    """
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError("pil_bilinear_resize_u8 takes a (H, W) uint8 image")
    out = img
    if out_w != img.shape[1]:
        out = _pil_pass(out, out_w, 1)
    if out_h != img.shape[0]:
        out = _pil_pass(out, out_h, 0)
    return out.copy() if out is img else out
