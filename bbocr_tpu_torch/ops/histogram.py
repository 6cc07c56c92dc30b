"""CLAHE (cv2.createCLAHE(clip_limit, tiles).apply) on tensors.

Counterpart of ``bbocr_tpu/ops/histogram.py::clahe``, holding its results
bit for bit. The tile histograms, clipping, residual redistribution and
LUTs are integer arithmetic. The bilinear blend of the four neighbouring
tile LUTs repeats the reference's float32 arithmetic: the image is cut
into half-tile-shifted blocks whose pixels share four LUTs; each LUT value
L splits as 2*floor(L/2) + (L mod 2), and the eight products with the
weights (2*w, w) are accumulated in that order by fused multiply-adds, as
XLA does. Each multiply-add is done in float64, where it is exact for
these operands, and rounded to float32 once, which is what a fused
multiply-add does.
"""

from __future__ import annotations

import torch

from bbocr_tpu_torch.ops.filters import pad2d


def _clahe_luts(vals: torch.Tensor, tiles_y: int, tiles_x: int, clip_limit: float) -> torch.Tensor:
    """(n, hp, wp) int64 -> (n, tiles_y, tiles_x, 256) float32 LUTs, cv2 math."""
    n, hp, wp = vals.shape
    th, tw = hp // tiles_y, wp // tiles_x
    tile_area = th * tw
    tile_id = (
        torch.arange(n * tiles_y * tiles_x, device=vals.device)
        .reshape(n, tiles_y, 1, tiles_x, 1)
        .expand(n, tiles_y, th, tiles_x, tw)
        .reshape(n, hp, wp)
    )
    hist = torch.bincount(
        (tile_id * 256 + vals).reshape(-1), minlength=n * tiles_y * tiles_x * 256
    ).reshape(-1, 256)
    clip = max(int(clip_limit * tile_area / 256.0), 1)
    clipped = (hist - clip).clamp(min=0).sum(dim=1, keepdim=True)
    hist = hist.clamp(max=clip)
    redist = clipped // 256
    residual = clipped - redist * 256
    hist = hist + redist
    # cv2 adds 1 at bins 0, s, 2s, ... while the residual lasts, s = max(256 // residual, 1)
    idx = torch.arange(256, device=vals.device)[None, :]
    step = torch.clamp(256 // torch.clamp(residual, min=1), min=1)
    hit = (idx % step == 0) & (idx < residual * step) & (residual > 0)
    hist = hist + hit.to(hist.dtype)
    lut = torch.round(torch.cumsum(hist, dim=1).to(torch.float32) * (255.0 / float(tile_area)))
    return lut.clamp(0, 255).reshape(n, tiles_y, tiles_x, 256)


def _clahe_batched(img: torch.Tensor, clip_limit: float, tiles_y: int, tiles_x: int) -> torch.Tensor:
    n, h, w = img.shape
    th = -(-h // tiles_y)
    tw = -(-w // tiles_x)
    hp, wp = th * tiles_y, tw * tiles_x
    padded = pad2d(img, 0, hp - h, 0, wp - w, "reflect101")
    vals = torch.clamp(torch.round(padded), 0, 255).to(torch.int64)
    luts = _clahe_luts(vals, tiles_y, tiles_x, clip_limit)

    # Pixel (y, x) falls in shifted block (by, bx) at offset (i, j); the
    # block blends the LUTs of tiles (by-1, by) x (bx-1, bx), clipped.
    pt, pl = th // 2, tw // 2
    dev = img.device
    ys = torch.arange(h, device=dev) + pt
    xs = torch.arange(w, device=dev) + pl
    by, i = ys // th, ys % th
    bx, j = xs // tw, xs % tw
    ty = (torch.clamp(by - 1, 0, tiles_y - 1), torch.clamp(by, 0, tiles_y - 1))
    tx = (torch.clamp(bx - 1, 0, tiles_x - 1), torch.clamp(bx, 0, tiles_x - 1))
    ya = (torch.arange(th, device=dev, dtype=torch.float32) - pt) / th + 0.5
    xa = (torch.arange(tw, device=dev, dtype=torch.float32) - pl) / tw + 0.5
    wy = (1.0 - ya[i], ya[i])  # (h,)
    wx = (1.0 - xa[j], xa[j])  # (w,)

    v = vals[:, :h, :w]
    nidx = torch.arange(n, device=dev)[:, None, None]
    looked = []
    weights = []
    for a in (0, 1):
        for b in (0, 1):
            lut = luts[nidx, ty[a][None, :, None], tx[b][None, None, :], v]
            looked.append(lut)
            weights.append(wy[a][:, None] * wx[b][None, :])
    halves = [torch.floor(lut / 2.0) for lut in looked]
    odds = [lut - 2.0 * hf for lut, hf in zip(looked, halves)]
    factors = list(zip(halves + odds, [2.0 * wt for wt in weights] + weights))
    out = torch.zeros_like(looked[0])
    for a, b in factors:
        out = (a.double() * b.double() + out.double()).float()
    return torch.clamp(torch.round(out), 0, 255)


def clahe(img: torch.Tensor, clip_limit: float = 2.0, tile_grid: tuple = (8, 8)) -> torch.Tensor:
    """cv2.createCLAHE(clipLimit, tileGridSize).apply on (..., H, W)."""
    ty, tx = tile_grid
    if img.ndim == 2:
        return _clahe_batched(img[None], clip_limit, ty, tx)[0]
    flat = img.reshape((-1,) + img.shape[-2:])
    out = _clahe_batched(flat, clip_limit, ty, tx)
    return out.reshape(img.shape[:-2] + out.shape[-2:])
