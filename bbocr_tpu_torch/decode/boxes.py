"""CRAFT score maps -> word quadrilaterals (host geometry step).

Counterpart of ``bbocr_tpu/decode/boxes.py``: threshold the region/affinity
maps (done on the device), label connected components, filter by
population and peak region score, and emit a rotated min-area rectangle
per component grown by the CRAFT dilation margin. The engine runs the C++
labeler (``bbocr_tpu_torch.native``); ``extract_boxes_masked_plain`` is the
numpy version the tests hold it against.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

from bbocr_tpu_torch.native import connected_components_numpy, extract_quads_masked_native


@dataclass(frozen=True)
class DetectionParams:
    # Standard CRAFT/EasyOCR thresholds (readtext defaults).
    text_threshold: float = 0.7
    link_threshold: float = 0.4
    low_text: float = 0.4
    min_size_px: int = 10
    # Re-segment components that fused stacked text lines (cover title
    # blocks) using the region-map row profile — see split_multiline_quads.
    split_multiline: bool = True


def _cross2(o: np.ndarray, a: np.ndarray, b: np.ndarray) -> float:
    return float((a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0]))


def _reduce_points_for_hull(points: np.ndarray) -> np.ndarray:
    """Exact hull-preserving reduction for pixel point sets.

    For each integer row keep only the row's min-x and max-x points: every
    other point of that row lies on the segment between them, hence inside
    the hull of the kept set, so hull(reduced) == hull(all). This turns the
    Python-loop monotone chain over every component pixel into a loop over
    <= 2 points per row. Applied only when the ys sit on an integer grid
    (pixel coordinates always do); arbitrary float sets pass through.
    """
    if len(points) <= 192:
        return points
    y = points[:, 1]
    yr = np.rint(y)
    if not np.all(np.abs(y - yr) < 1e-6):
        return points
    uy, inv = np.unique(yr, return_inverse=True)
    minx = np.full(len(uy), np.inf)
    maxx = np.full(len(uy), -np.inf)
    np.minimum.at(minx, inv, points[:, 0])
    np.maximum.at(maxx, inv, points[:, 0])
    return np.concatenate(
        [np.stack([minx, uy], axis=1), np.stack([maxx, uy], axis=1)]
    )


def _convex_hull(points: np.ndarray) -> np.ndarray:
    """Monotone-chain convex hull; points (N,2) -> hull (M,2) CCW."""
    pts = np.unique(_reduce_points_for_hull(points), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    # Plain-float tuples: python float math is much cheaper than numpy
    # scalar indexing inside the chain loop, and exact either way.
    pts_list = [(float(x), float(y)) for x, y in pts.tolist()]

    def half(seq):
        out: List[tuple] = []
        for x, y in seq:
            while (
                len(out) >= 2
                and (out[-1][0] - out[-2][0]) * (y - out[-2][1])
                - (out[-1][1] - out[-2][1]) * (x - out[-2][0])
                <= 0
            ):
                out.pop()
            out.append((x, y))
        return out

    lower = half(pts_list)
    upper = half(pts_list[::-1])
    return np.asarray(lower[:-1] + upper[:-1], np.float64)


def _min_area_rect(points: np.ndarray) -> np.ndarray:
    """Rotating-calipers min-area rectangle; returns 4 corners (4,2)."""
    hull = _convex_hull(points.astype(np.float64))
    if len(hull) == 1:
        p = hull[0]
        return np.tile(p, (4, 1))
    if len(hull) == 2:
        a, b = hull
        return np.asarray([a, b, b, a], np.float64)
    edges = np.diff(np.vstack([hull, hull[:1]]), axis=0)
    angles = np.unique(np.mod(np.arctan2(edges[:, 1], edges[:, 0]), math.pi / 2))
    best = None
    for ang in angles:
        c, s = math.cos(ang), math.sin(ang)
        rot = np.array([[c, s], [-s, c]])
        proj = hull @ rot.T
        mins = proj.min(axis=0)
        maxs = proj.max(axis=0)
        area = np.prod(maxs - mins)
        if best is None or area < best[0]:
            best = (area, ang, mins, maxs)
    _, ang, mins, maxs = best
    c, s = math.cos(ang), math.sin(ang)
    rot = np.array([[c, s], [-s, c]])
    corners = np.array(
        [
            [mins[0], mins[1]],
            [maxs[0], mins[1]],
            [maxs[0], maxs[1]],
            [mins[0], maxs[1]],
        ]
    )
    return corners @ rot


def _order_clockwise(box: np.ndarray) -> np.ndarray:
    """Start at top-left, clockwise (the CRAFT convention)."""
    start = np.argmin(box.sum(axis=1))
    box = np.roll(box, -start, axis=0)
    # Ensure clockwise in image coordinates (y down).
    if _cross2(box[0], box[1], box[2]) < 0:
        box = box[[0, 3, 2, 1]]
    return box


def extract_boxes(
    region: np.ndarray,
    affinity: np.ndarray,
    params: DetectionParams = DetectionParams(),
) -> List[np.ndarray]:
    """(H, W) float32 score maps -> list of (4, 2) float quads (map coords).

    The CRAFT recipe: components of
    (region > low_text) | (affinity > link_threshold), kept when population
    >= min_size and max region score >= text_threshold, expanded by
    niter = sqrt(area * min(w, h) / (w * h)) * 2. Counterpart of the JAX
    package's float-map entry; the engines use :func:`extract_boxes_masked`.
    """
    mask = (region > params.low_text) | (affinity > params.link_threshold)
    return _extract_boxes_from_mask(mask, region, params)


def extract_boxes_masked(
    mask: np.ndarray,
    region_q: np.ndarray,
    params: DetectionParams = DetectionParams(),
) -> List[np.ndarray]:
    """Postprocessing for device-thresholded detection, in the C++ labeler.

    ``mask``: (H, W) uint8/bool computed on the device as
    (region > low_text) | (affinity > link_threshold); ``region_q``: (H, W)
    uint8 = round(region * 255).
    """
    quads = extract_quads_masked_native(mask, region_q, params.text_threshold, params.min_size_px)
    return [q for q in quads]


def extract_boxes_masked_plain(
    mask: np.ndarray,
    region_q: np.ndarray,
    params: DetectionParams = DetectionParams(),
) -> List[np.ndarray]:
    """numpy version of :func:`extract_boxes_masked` (same contract)."""
    return _extract_boxes_from_mask(
        np.asarray(mask) != 0, region_q.astype(np.float32) / 255.0, params
    )


def _extract_boxes_from_mask(
    mask: np.ndarray, region: np.ndarray, params: DetectionParams
) -> List[np.ndarray]:
    labels, stats = connected_components_numpy(mask.astype(np.uint8), score=region, connectivity=4)
    if stats.shape[0] == 0:
        return []

    keep_ids = []
    for idx in range(stats.shape[0]):
        x0, y0, x1, y1, count = stats[idx, :5]
        if count < params.min_size_px:
            continue
        if stats[idx, 10] < params.text_threshold:
            continue
        keep_ids.append(idx)
    if not keep_ids:
        return []

    # Group pixel coordinates by label in one pass.
    flat = labels.ravel()
    order = np.argsort(flat, kind="stable")
    sorted_labels = flat[order]
    w = labels.shape[1]
    ys, xs = np.divmod(order, w)
    bounds = np.searchsorted(sorted_labels, np.arange(1, stats.shape[0] + 2))

    quads = []
    for idx in keep_ids:
        lo, hi = bounds[idx], bounds[idx + 1]
        pts = np.stack([xs[lo:hi], ys[lo:hi]], axis=1)
        x0, y0, x1, y1, count = stats[idx, :5]
        bw, bh = x1 - x0 + 1, y1 - y0 + 1
        niter = int(math.sqrt(count * min(bw, bh) / (bw * bh)) * 2.0)
        rect = _min_area_rect(pts)
        # Grow by the dilation margin (Minkowski sum with a square ~ expand
        # each side); also mirror CRAFT's diamond-to-axis-aligned fallback.
        center = rect.mean(axis=0)
        side1 = np.linalg.norm(rect[1] - rect[0])
        side2 = np.linalg.norm(rect[2] - rect[1])
        if min(side1, side2) > 0:
            ratio = max(side1, side2) / (min(side1, side2) + 1e-5)
            if abs(1 - ratio) <= 0.1:
                # Near-square: fall back to the axis-aligned box.
                l, r = pts[:, 0].min(), pts[:, 0].max()
                t, b = pts[:, 1].min(), pts[:, 1].max()
                rect = np.array([[l, t], [r, t], [r, b], [l, b]], np.float64)
                center = rect.mean(axis=0)
        grow = niter + 1.0
        dirs = rect - center
        norms = np.linalg.norm(dirs, axis=1, keepdims=True)
        rect = rect + dirs / np.maximum(norms, 1e-6) * grow * math.sqrt(2.0)
        quads.append(_order_clockwise(rect))
    return quads


def split_multiline_quads(
    quads: List[np.ndarray],
    region: np.ndarray,
    low_text: float = 0.4,
    min_size_px: int = 10,
) -> List[np.ndarray]:
    """Split components that fused several stacked text lines into one quad.

    CRAFT's affinity map glues characters into words; on dense cover-title
    blocks it also glues LINES vertically, so the CC step emits one huge
    component spanning the whole block (on data/real/covers, quads
    swallowing "MICHAEL MOORCOCK / ELRIC OF / MELNIBONE"; the rectified
    crop is then unreadable). EasyOCR shows the
    same failure; splitting is a strict improvement over the reference
    behavior, not a parity break.

    The REGION map alone separates lines (gaps between baselines score ~0):
    within each quad, segment the row profile of ``region > low_text`` at
    its valleys and emit one min-area rect per line-shaped segment. The
    profile runs along the QUAD's height axis (its edge closest to image-
    vertical), not image rows: hand-held cover photos tilt the book 10-30°
    (data/real/covers/book1 at -14.5°), and along image rows the rotated
    lines overlap with no valley — the fused "HARRY POTTER" block survived
    the axis-aligned profile unsplit. For axis-aligned quads the rotated
    profile reduces to the original row profile exactly.
    Guards: a quad is replaced only when >= 2 segments emerge, each clearly
    shorter than the original, and the majority are wider than tall —
    vertical spine text and display drop-caps fall through unchanged (their
    profiles have no line-shaped valleys).
    """
    h_map, w_map = region.shape
    hot = region > low_text
    out: List[np.ndarray] = []
    for q in quads:
        x0 = int(max(0, math.floor(q[:, 0].min())))
        x1 = int(min(w_map, math.ceil(q[:, 0].max()) + 1))
        y0 = int(max(0, math.floor(q[:, 1].min())))
        y1 = int(min(h_map, math.ceil(q[:, 1].max()) + 1))
        qh, qw = y1 - y0, x1 - x0
        if qh < 16 or qw < 4:
            out.append(q)
            continue
        ys_a, xs_a = np.nonzero(hot[y0:y1, x0:x1])
        if ys_a.size < min_size_px:
            out.append(q)
            continue
        pts_all = np.stack(
            [xs_a.astype(np.float32) + x0, ys_a.astype(np.float32) + y0], axis=1
        )
        # Keep only pixels inside the quad polygon: the bbox of a rotated
        # quad overlaps neighboring components, whose pixels would corrupt
        # the profile. Sign-agnostic convex test (quads are rectangles from
        # _min_area_rect; winding depends on source).
        edge_cross = np.stack(
            [
                (q[(i + 1) % 4, 0] - q[i, 0]) * (pts_all[:, 1] - q[i, 1])
                - (q[(i + 1) % 4, 1] - q[i, 1]) * (pts_all[:, 0] - q[i, 0])
                for i in range(4)
            ]
        )
        # cross = |edge| * perpendicular distance, so the boundary slack must
        # scale with edge length: tol rows give +-1.5 px of true distance.
        edge_norm = np.array(
            [max(float(np.hypot(q[(i + 1) % 4, 0] - q[i, 0],
                                q[(i + 1) % 4, 1] - q[i, 1])), 1.0)
             for i in range(4)], dtype=np.float32)[:, None]
        tol = 1.5 * edge_norm
        inside = (edge_cross >= -tol).all(axis=0) | (edge_cross <= tol).all(axis=0)
        if int(inside.sum()) < min_size_px:
            out.append(q)
            continue
        pts_all = pts_all[inside]
        # Quad frame: v = unit edge closest to image-vertical (height axis),
        # u = the other edge direction (reading axis).
        e01 = q[1] - q[0]
        e03 = q[3] - q[0]
        n01 = float(np.linalg.norm(e01)) or 1.0
        n03 = float(np.linalg.norm(e03)) or 1.0
        if abs(e03[1]) / n03 >= abs(e01[1]) / n01:
            u, v = e01 / n01, e03 / n03
        else:
            u, v = e03 / n03, e01 / n01
        rx = pts_all @ u.astype(np.float32)
        ry = pts_all @ v.astype(np.float32)
        ry0 = float(ry.min())
        rows_idx = np.floor(ry - ry0).astype(np.int64)
        n_rows = int(rows_idx.max()) + 1
        if n_rows < 16:
            out.append(q)
            continue
        prof = np.bincount(rows_idx, minlength=n_rows).astype(np.float32)
        # smooth over 3 rows so single-row pinholes don't split glyphs
        prof = np.convolve(prof, np.ones(3, np.float32) / 3.0, mode="same")
        on = prof >= max(1.0, 0.18 * float(prof.max()))
        # row segments (runs of on), bridging 1-row gaps
        segs: List[tuple] = []
        start = None
        gap = 0
        for i, bv in enumerate(on):
            if bv:
                if start is None:
                    start = i
                gap = 0
            elif start is not None:
                gap += 1
                if gap > 1:
                    segs.append((start, i - gap + 1))
                    start = None
        if start is not None:
            segs.append((start, len(on)))
        segs = [(a, b) for a, b in segs if b - a >= 3]
        if len(segs) < 2:
            out.append(q)
            continue
        med_h = float(np.median([b - a for a, b in segs]))
        if med_h > 0.6 * n_rows:
            out.append(q)
            continue
        pieces: List[np.ndarray] = []
        line_shaped = 0
        for a, b in segs:
            sel = (rows_idx >= a) & (rows_idx < b)
            if int(sel.sum()) < min_size_px:
                continue
            rx_s = rx[sel]
            if (float(rx_s.max()) - float(rx_s.min()) + 1.0) >= 1.3 * (b - a):
                line_shaped += 1
            pts = pts_all[sel]
            rect = _min_area_rect(pts)
            center = rect.mean(axis=0)
            dirs = rect - center
            norms = np.linalg.norm(dirs, axis=1, keepdims=True)
            rect = rect + dirs / np.maximum(norms, 1e-6) * 2.0 * math.sqrt(2.0)
            pieces.append(_order_clockwise(rect))
        if len(pieces) >= 2 and line_shaped * 2 >= len(pieces):
            out.extend(pieces)
        else:
            out.append(q)
    return out


def merge_coarse_quads(
    fine: List[np.ndarray],
    coarse: List[np.ndarray],
    giant_min_px: float = 96.0,
    covered_thresh: float = 0.5,
    absorb_thresh: float = 0.7,
) -> List[np.ndarray]:
    """Merge the quads of a coarse (pooled) detect pass into the fine ones.

    Counterpart of ``bbocr_tpu/decode/boxes.py::merge_coarse_quads``. The
    fine pass stays the source of truth; a coarse quad is added only when
    it is giant (its shorter side at least ``giant_min_px`` canvas px) and
    fine quads cover less than ``covered_thresh`` of its area. Fine quads
    lying at least ``absorb_thresh`` inside an adopted coarse quad are
    dropped as fragments of its glyphs. Overlaps are taken on axis-aligned
    bounding boxes; all quads are in the same (canvas) coordinates.
    """

    def aabb(q: np.ndarray):
        return float(q[:, 0].min()), float(q[:, 1].min()), float(q[:, 0].max()), float(q[:, 1].max())

    def inter(a, b) -> float:
        w = min(a[2], b[2]) - max(a[0], b[0])
        h = min(a[3], b[3]) - max(a[1], b[1])
        return max(0.0, w) * max(0.0, h)

    def area(a) -> float:
        return max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])

    fine_boxes = [aabb(q) for q in fine]
    adopted: List[np.ndarray] = []
    adopted_boxes = []
    for cq in coarse:
        cb = aabb(cq)
        if min(cb[2] - cb[0], cb[3] - cb[1]) < giant_min_px:
            continue
        ca = area(cb)
        if ca <= 0:
            continue
        if sum(inter(cb, fb) for fb in fine_boxes) / ca < covered_thresh:
            adopted.append(cq)
            adopted_boxes.append(cb)
    if not adopted:
        return list(fine)
    out: List[np.ndarray] = []
    for q, fb in zip(fine, fine_boxes):
        fa = area(fb)
        if not (fa > 0 and any(inter(fb, ab) / fa >= absorb_thresh for ab in adopted_boxes)):
            out.append(q)
    out.extend(adopted)
    return out


def group_lines(quads: List[np.ndarray]) -> List[List[int]]:
    """Cluster quads into text lines, top-to-bottom / left-to-right.

    Mirrors the line-grouping the reference gets from EasyOCR's
    group_text_box (``enhanced_extractor.py:521``); also feeds the
    heuristics structurer, which wants line structure.
    """
    if not quads:
        return []
    centers = np.array([q.mean(axis=0) for q in quads])
    heights = np.array([q[:, 1].max() - q[:, 1].min() for q in quads])
    order = np.argsort(centers[:, 1], kind="stable")
    lines: List[List[int]] = []
    line_y: List[float] = []
    for i in order:
        cy = centers[i, 1]
        tol = max(heights[i] * 0.5, 1.0)
        if lines and abs(cy - line_y[-1]) <= tol:
            lines[-1].append(int(i))
            line_y[-1] = (line_y[-1] * (len(lines[-1]) - 1) + cy) / len(lines[-1])
        else:
            lines.append([int(i)])
            line_y.append(float(cy))
    for line in lines:
        line.sort(key=lambda i: centers[i, 0])
    return lines


def sort_reading_order(quads: List[np.ndarray]) -> List[int]:
    """Flat indices in reading order (see :func:`group_lines`)."""
    return [i for line in group_lines(quads) for i in line]
