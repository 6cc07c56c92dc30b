"""Host crop rectification, the JAX engine's default recognition input.

Counterpart of ``bbocr_tpu/runtime/wire.py::host_warp_crop``: each crop is
warped on the host from the original gray photo at its native detail, and
small uint8 strips go to the device, instead of the device warp from the
letterboxed canvas. The JAX package calls OpenCV; the port calls its own
C++ warp (``native/warp.py``), bit for bit the same. The wire packing of
the JAX module (``wire_bits < 8``) is not ported (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import numpy as np

from bbocr_tpu_torch.native.warp import resize_area_u8, warp_perspective_u8


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
