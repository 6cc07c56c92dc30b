"""Host<->device wire reduction: bit-packed canvas upload and host crop
rectification.

Counterpart of ``bbocr_tpu/runtime/wire.py``:

1. **Bit-packed canvases** (``pack_canvas`` on the host, ``unpack_widen``
   on the device): the detect canvas ships at 4, 2 or 1 bits per pixel,
   ordered-dithered with the 4x4 Bayer matrix, and is unpacked to float32
   by shifts and masks on the device.
2. **Host rectification** (``host_warp_crop``): each recognition crop is
   warped on the host from the original gray photo at its native detail,
   and small uint8 strips go to the device, instead of the device warp from
   the letterboxed canvas. The JAX package calls OpenCV; the port calls its
   own C++ warp (``native/warp.py``), bit for bit the same.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from bbocr_tpu_torch.native.warp import resize_area_u8, warp_perspective_u8

# Bayer 4x4 ordered-dither index matrix (the standard recursive construction).
_BAYER4 = np.array([[0, 8, 2, 10], [12, 4, 14, 6], [3, 11, 1, 9], [15, 7, 13, 5]], np.int32)

_DITHER_CACHE: Dict[Tuple[int, int], np.ndarray] = {}


def _dither_plane(h: int, w: int) -> np.ndarray:
    """(h, w) int32 tile of the Bayer matrix (cached per shape)."""
    plane = _DITHER_CACHE.get((h, w))
    if plane is None:
        plane = _DITHER_CACHE[(h, w)] = np.tile(_BAYER4, (-(-h // 4), -(-w // 4)))[:h, :w]
    return plane


def quantize_dithered(gray_u8: np.ndarray, bits: int) -> np.ndarray:
    """Ordered-dither quantize (..., H, W) uint8 to 2**bits levels (uint8
    indices), in integers: q = floor(x / s + (B + 0.5) / 16) for the step
    s = 255 / (L - 1), computed as (32 x (L - 1) + 255 (2B + 1)) // (32 * 255).
    Dequantization is q * s (0 and 255 exact)."""
    levels = (1 << bits) - 1
    b = _dither_plane(gray_u8.shape[-2], gray_u8.shape[-1])
    num = 32 * levels * gray_u8.astype(np.int32) + 255 * (2 * b + 1)
    return np.minimum(num // (32 * 255), levels).astype(np.uint8)


def pack_canvas(batch_u8: np.ndarray, bits: int) -> np.ndarray:
    """(n, H, W) uint8 canvas -> (n, H, W * bits / 8) packed uint8,
    most significant bits first. ``bits=8`` returns the input; W must be a
    multiple of 8 / bits (canvas widths are multiples of 32)."""
    if bits == 8:
        return batch_u8
    q = quantize_dithered(batch_u8, bits)
    if bits == 4:
        return ((q[..., 0::2] << 4) | q[..., 1::2]).astype(np.uint8)
    if bits == 2:
        return ((q[..., 0::4] << 6) | (q[..., 1::4] << 4) | (q[..., 2::4] << 2) | q[..., 3::4]).astype(np.uint8)
    if bits == 1:
        out = np.zeros(q.shape[:-1] + (q.shape[-1] // 8,), np.uint8)
        for i in range(8):
            out |= q[..., i::8] << (7 - i)
        return out
    raise ValueError(f"wire_bits must be 1, 2, 4, or 8 (got {bits})")


def unpack_widen(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Device-side inverse of :func:`pack_canvas`: (n, H, Wp) uint8 ->
    (n, H, Wp * 8 / bits) float32 in [0, 255], by shifts and masks."""
    if bits == 8:
        return packed.to(torch.float32)
    if bits not in (1, 2, 4):
        raise ValueError(f"wire_bits must be 1, 2, 4, or 8 (got {bits})")
    n, h, wp = packed.shape
    mask = (1 << bits) - 1
    shifts = range(8 - bits, -1, -bits)  # most significant field first
    parts = torch.stack([(packed >> s) & mask for s in shifts], dim=-1)
    # 255 / 15, 255 / 3 and 255 are integers, so each level is exact
    return parts.reshape(n, h, wp * (8 // bits)).to(torch.float32) * float(255 // mask)


def host_warp_crop(
    gray_u8: np.ndarray,
    quad: np.ndarray,
    true_w: int,
    out_h: int,
    bucket_w: int,
    homography_fn,
) -> np.ndarray:
    """Rectify one quad from the original image on the host -> (out_h, bucket_w) u8.

    Supersamples (warp at k x, then an area average down) when the source
    line is much taller than out_h, since the bilinear taps alias on large
    downscales. Columns past true_w replicate the last valid column, the
    padding of the device warp (``rectify.warp_crops``).
    """
    q = np.asarray(quad, np.float64)
    h_src = max(float(np.linalg.norm(q[3] - q[0])), float(np.linalg.norm(q[2] - q[1])))
    k = int(np.clip(round(h_src / out_h), 1, 4))
    # dst -> src homography for the k x supersampled output grid directly
    m = homography_fn(q, true_w * k, out_h * k).astype(np.float64)
    crop = warp_perspective_u8(gray_u8, m, true_w * k, out_h * k)
    if k > 1:
        crop = resize_area_u8(crop, k)
    if bucket_w > true_w:
        crop = np.pad(crop, ((0, 0), (0, bucket_w - true_w)), mode="edge")
    return crop
