"""Resize as two matrix products, cv2 INTER_CUBIC and INTER_LINEAR parity;
and Pillow's BILINEAR and BICUBIC resamples and its ``reduce`` of a uint8
image, in numpy.

Counterpart of ``bbocr_tpu/ops/resize.py``: ``out = W_rows @ img @ W_cols^T``
with the (n_out, n_in) resampling matrices built in numpy (half-pixel
centers, cubic a = -0.75 or linear, edge clamping). The products are plain
``torch.matmul`` calls outside any kernel; in float32 they must not run in
TF32, which would cost the uint8 parity. ``pil_resample_u8`` is the
extractor's BILINEAR downscale of photos over its size limit and, after
``pil_reduce_u8``, the BICUBIC pass of ``io.pil_thumbnail_u8`` (host work,
as the JAX extractor's Pillow calls are).
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


def _bilinear_filter(x: np.ndarray) -> np.ndarray:
    return np.maximum(1.0 - np.abs(x), 0.0)


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    """Resample.c ``bicubic_filter``: cubic convolution with a = -0.5."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_PIL_FILTERS = {"bilinear": (_bilinear_filter, 1.0), "bicubic": (_bicubic_filter, 2.0)}


def _pil_coeffs(in_size: int, out_size: int, kind: str = "bilinear", box=None):
    """``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for one of Pillow's
    filters over the source span ``box`` = (in0, in1), which Pillow passes
    as float32: (first source index, int64 weights (out, ksize))."""
    filt, filter_support = _PIL_FILTERS[kind]
    in0, in1 = (0.0, float(in_size)) if box is None else box
    in0, in1 = np.float32(in0), np.float32(in1)
    scale = float(np.float32(in1 - in0)) / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = float(in0) + (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = filt((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w[taps[None, :] >= xmax[:, None]] = 0.0
    total = np.zeros(out_size)
    for k in range(ksize):  # summed in tap order, as the C loop does
        total += w[:, k]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    scaled = w * (1 << _PIL_PRECISION_BITS)
    fixed = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)
    return xmin, fixed


def _pil_pass(img: np.ndarray, out_size: int, axis: int, kind: str = "bilinear", box=None) -> np.ndarray:
    """One 8-bit resampling pass along ``axis`` (0 rows, 1 columns)."""
    xmin, k = _pil_coeffs(img.shape[axis], out_size, kind, box)
    # int32 sums, as Resample.c's: the filtered axis first and contiguous,
    # so that each tap gathers whole rows
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0)).astype(np.int32)
    k = k.astype(np.int32)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :], src.shape[0] - 1)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PIL_PRECISION_BITS - 1), np.int32)
    for t in range(k.shape[1]):
        acc += src[idx[:, t]] * k[:, t].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_resample_u8(img: np.ndarray, out_w: int, out_h: int, kind: str = "bilinear", box=None) -> np.ndarray:
    """``Image.resize((out_w, out_h), BILINEAR or BICUBIC, box)`` on a
    (H, W) or (H, W, C) uint8 array, bit for bit, in numpy.

    Pillow's ``Resample.c``: the filter's support widens with the downscale
    factor, sample centres at ``in0 + (x + 0.5) * scale`` over the box,
    weights normalised and turned into 22-bit fixed point; the horizontal
    pass runs first, each pass rounds and clips to uint8, and a pass whose
    size and span do not change is skipped."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = (0.0, 0.0, float(w), float(h)) if box is None else (np.float32(v) for v in box)
    out = img
    if out_w != w or x0 != 0 or x1 != out_w:
        out = _pil_pass(out, out_w, 1, kind, (x0, x1))
    if out_h != h or y0 != 0 or y1 != out_h:
        out = _pil_pass(out, out_h, 0, kind, (y0, y1))
    return out.copy() if out is img else out


def pil_reduce_u8(img: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """``Image.reduce((fx, fy))`` on a (H, W) or (H, W, C) uint8 array:
    the mean of each fx-by-fy block, the last column and row of blocks
    partial, rounded as ``Reduce.c`` rounds (half the count added, then a
    float32 reciprocal in 24-bit fixed point)."""
    h, w = img.shape[:2]
    oh, ow = -(-h // fy), -(-w // fx)
    pad = np.zeros((oh * fy, ow * fx) + img.shape[2:], np.int64)
    pad[:h, :w] = img
    sums = pad.reshape((oh, fy, ow, fx) + img.shape[2:]).sum(axis=(1, 3))
    rows = np.minimum(fy, h - np.arange(oh) * fy)
    cols = np.minimum(fx, w - np.arange(ow) * fx)
    n = (rows[:, None] * cols[None, :]).reshape((oh, ow) + (1,) * (img.ndim - 2))
    mult = (np.float32(4294967296.0) / (np.float32(256) * n.astype(np.float32))).astype(np.int64)
    return (((sums + n // 2) * mult) >> 24).astype(np.uint8)
