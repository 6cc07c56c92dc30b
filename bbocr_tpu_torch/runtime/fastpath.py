"""Single-dispatch fast path: detect -> label -> box -> rectify -> recognize
with one canvas upload and one small download per photo.

Counterpart of ``bbocr_tpu/runtime/fastpath.py``:

  canvas -> CRAFT -> threshold mask -> iterative CC labeling
  (``decode.cc_device``) -> top-K component boxes and peak scores ->
  axis-aligned quads grown by the CRAFT dilation margin -> affine crop
  sampling from the canvas -> CRNN -> greedy CTC decode

Component quads are axis-aligned bounding boxes, not the rotated
min-area rectangles of the host path. The JAX package compiles the chain
into one XLA program; here it is one function of device ops whose only
host synchronisations are the labeling's convergence checks.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from bbocr_tpu_torch.decode.cc_device import component_stats_device, label_components_device
from bbocr_tpu_torch.decode.ctc import ctc_greedy_decode
from bbocr_tpu_torch.models.crnn import INPUT_HEIGHT
from bbocr_tpu_torch.runtime.rectify import warp_crops

_SQRT2 = float(np.float32(math.sqrt(2.0)))


def device_boxes_from_mask(
    mask: torch.Tensor,
    region: torch.Tensor,
    k: int,
    *,
    text_threshold: float,
    min_size_px: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) mask + region scores -> (k, 4) grown boxes, (k,) validity.

    Boxes are (x0, y0, x1, y1) float32 in mask coordinates, grown by the
    CRAFT dilation margin ``niter = sqrt(area * min(w, h) / (w * h)) * 2``
    along the corner directions, as the host path grows its rectangles."""
    labels, _ = label_components_device(mask)
    _, x0, y0, x1, y1, count, peak = component_stats_device(labels, k, score=region)
    valid = (count >= min_size_px) & (peak >= text_threshold)

    bw = (x1 - x0 + 1).to(torch.float32)
    bh = (y1 - y0 + 1).to(torch.float32)
    area = count.to(torch.float32)
    niter = torch.floor(torch.sqrt(area * torch.minimum(bw, bh) / (bw * bh + 1e-6)) * 2.0)
    grow = niter + 1.0
    # corners move along (corner - center) by grow * sqrt(2); componentwise
    # each half-extent grows by grow * sqrt(2) * (extent / diag)
    diag = torch.sqrt(bw * bw + bh * bh) + 1e-6
    dx = grow * _SQRT2 * bw / diag
    dy = grow * _SQRT2 * bh / diag
    boxes = torch.stack([x0.float() - dx, y0.float() - dy, x1.float() + dx, y1.float() + dy], dim=-1)
    return boxes, valid


@torch.no_grad()
def fast_readtext_program(engine, gray: torch.Tensor, k: int, bucket_w: int):
    """(1, H, W) float32 gray canvas in [0, 255] on the engine's device (a
    bit-packed upload already unpacked) ->
    (boxes (k, 4) canvas coords, ids (k, T), lens (k,), conf (k,), valid (k,))."""
    h, w = gray.shape[1:]
    det = engine.config.detection
    maps = engine.craft(engine.craft_input(gray))
    region, affinity = maps[0, 0], maps[0, 1]
    mask = (region > det.low_text) | (affinity > det.link_threshold)
    boxes_half, valid = device_boxes_from_mask(
        mask, region, k, text_threshold=det.text_threshold, min_size_px=det.min_size_px,
    )
    boxes = boxes_half * 2.0  # half-resolution map -> canvas coords
    x0 = torch.clamp(boxes[:, 0], 0.0, w - 1.0)
    y0 = torch.clamp(boxes[:, 1], 0.0, h - 1.0)
    x1 = torch.clamp(boxes[:, 2], 0.0, w - 1.0)
    y1 = torch.clamp(boxes[:, 3], 0.0, h - 1.0)
    bw = torch.clamp(x1 - x0 + 1.0, min=1.0)
    bh = torch.clamp(y1 - y0 + 1.0, min=1.0)

    true_w = torch.clamp(torch.round(INPUT_HEIGHT * bw / bh), 8, bucket_w).to(torch.int64)
    # affine output -> source map per box (axis-aligned rectangle)
    sx = bw / torch.clamp(true_w.to(torch.float32) - 1.0, min=1.0)
    sy = bh / float(INPUT_HEIGHT - 1)
    zeros, ones = torch.zeros_like(sx), torch.ones_like(sx)
    homos = torch.stack([
        torch.stack([sx, zeros, x0], dim=-1),
        torch.stack([zeros, sy, y0], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=1)
    crops = warp_crops(gray, homos, torch.zeros(k, dtype=torch.int64, device=gray.device), true_w, bucket_w)
    logits = engine.recognizer_logits(crops)
    lengths = torch.clamp(true_w // 4 - 1, min=1)
    ids, lens, conf = ctc_greedy_decode(logits, lengths)
    return torch.stack([x0, y0, x1, y1], dim=-1), ids, lens, conf, valid
