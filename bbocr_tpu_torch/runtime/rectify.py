"""Batched perspective rectification of detected quads, on the device.

Counterpart of ``bbocr_tpu/runtime/rectify.py``: all crops of a width
bucket are sampled in one bilinear gather warp from the letterboxed canvas.
"""

from __future__ import annotations

import numpy as np
import torch

from bbocr_tpu_torch.models.crnn import INPUT_HEIGHT


def quad_to_rect_homography(quad: np.ndarray, out_w: int, out_h: int = INPUT_HEIGHT) -> np.ndarray:
    """3x3 homography mapping output-rect pixel coords -> source coords.

    ``quad``: (4, 2) corners ordered top-left clockwise. Solves the 8-DOF
    DLT system for the 4-point correspondence (what
    cv2.getPerspectiveTransform computes, inverted direction).
    """
    dst = np.array(
        [[0, 0], [out_w - 1, 0], [out_w - 1, out_h - 1], [0, out_h - 1]],
        np.float64,
    )
    src = np.asarray(quad, np.float64)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        x, y = dst[i]
        u, v = src[i]
        a[2 * i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        b[2 * i] = u
        a[2 * i + 1] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[2 * i + 1] = v
    try:
        h = np.linalg.solve(a, b)
    except np.linalg.LinAlgError:
        h = np.linalg.lstsq(a, b, rcond=None)[0]
    return np.append(h, 1.0).reshape(3, 3)


def warp_crops(
    images: torch.Tensor,
    homos: torch.Tensor,
    img_idx: torch.Tensor,
    true_w: torch.Tensor,
    out_w: int,
) -> torch.Tensor:
    """Sample N perspective crops from a batch of grayscale images.

    ``images``: (B, H, W) float32; ``homos``: (N, 3, 3) float32
    output->source homographies; ``img_idx``: (N,) source image per crop;
    ``true_w``: (N,) valid output width per crop (columns beyond it repeat
    the last valid column). Returns (N, 32, out_w) float32 crops.
    """
    n = homos.shape[0]
    h_img, w_img = images.shape[1], images.shape[2]
    dev = images.device
    ys = torch.arange(INPUT_HEIGHT, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    xg = torch.minimum(xs[None, :], (true_w[:, None] - 1).to(torch.float32))  # (N, out_w)
    xg = xg[:, None, :].expand(n, INPUT_HEIGHT, out_w)
    yg = ys[None, :, None].expand(n, INPUT_HEIGHT, out_w)
    pts = torch.stack([xg, yg, torch.ones_like(xg)], dim=-1)  # (N, 32, out_w, 3)
    src = torch.einsum("nij,nhwj->nhwi", homos, pts)
    sx = src[..., 0] / torch.clamp(src[..., 2], min=1e-8)
    sy = src[..., 1] / torch.clamp(src[..., 2], min=1e-8)
    sx = torch.clamp(sx, 0.0, w_img - 1.0)
    sy = torch.clamp(sy, 0.0, h_img - 1.0)

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=w_img - 1)
    y1i = torch.clamp(y0i + 1, max=h_img - 1)

    flat = images.reshape(-1)
    base = img_idx.to(torch.int64)[:, None, None] * (h_img * w_img)

    def g(yy, xx):
        return flat[base + yy * w_img + xx]

    top = g(y0i, x0i) * (1 - fx) + g(y0i, x1i) * fx
    bot = g(y1i, x0i) * (1 - fx) + g(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy
