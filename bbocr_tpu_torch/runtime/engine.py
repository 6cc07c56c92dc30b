"""The OCR engine: photo(s) -> [(quad, text, confidence)].

Counterpart of ``bbocr_tpu/runtime/engine.py::OCREngine`` on one device:

- letterbox each photo onto a canvas from the menu (host, uint8, cv2's
  fixed-point bilinear resize);
- detect: CRAFT with the folded gray stem, thresholds applied on the
  device, two uint8 planes downloaded per canvas;
- boxes: the C++ labeler on the host, then the multi-line split;
- rectify: one bilinear gather warp per width bucket, on the device, from
  the letterboxed canvas;
- recognize: CRNN + greedy CTC on the device, with the contrast-stretch
  retry for low-confidence crops;
- collect in reading order, back in image coordinates.

Options of the JAX engine whose modules are not ported yet raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from bbocr_tpu_torch.decode import (
    DetectionParams,
    ctc_greedy_decode,
    extract_boxes_masked,
    sort_reading_order,
    split_multiline_quads,
)
from bbocr_tpu_torch.models import (
    CRAFT,
    CRNN,
    EN_CHARSET,
    Charset,
    cast_for_compute,
    charset_for_num_classes,
    craft_state_dict,
    crnn_state_dict,
    fold_gray_stem,
)
from bbocr_tpu_torch.runtime import bucketing
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec
from bbocr_tpu_torch.runtime.rectify import quad_to_rect_homography, warp_crops
from bbocr_tpu_torch.utils.checkpoint import load_params
from bbocr_tpu_torch.utils.profiling import StageTimer

# Photos per detect batch; a batch's row count is padded to this menu.
_CHUNK = 8
_ROW_MENU = (1, 2, 4, _CHUNK)


@dataclass(frozen=True)
class EngineConfig:
    canvases: Tuple[CanvasSpec, ...] = field(default_factory=bucketing.default_canvases)
    width_buckets: Tuple[int, ...] = bucketing.DEFAULT_WIDTH_BUCKETS
    batch_capacities: Tuple[int, ...] = bucketing.DEFAULT_CAPACITIES
    detection: DetectionParams = field(default_factory=DetectionParams)
    # Minimum recognition confidence to keep a box (0.0 keeps all).
    min_confidence: float = 0.0
    # Crops below this confidence are re-read contrast-stretched.
    contrast_ths: float = 0.1
    # torch.bfloat16 or torch.float32 for the CRAFT and CRNN forwards.
    compute_dtype: torch.dtype = torch.bfloat16
    # Requests of fewer images than this merge all width buckets into the
    # widest one needed.
    merge_buckets_below: int = 2
    # Options of the JAX engine not ported yet: only these values run.
    wire_bits: int = 8
    host_rectify: bool = False


def _check_ported(config: EngineConfig) -> None:
    unported = {
        "host_rectify=True (host crop rectification, runtime/wire.py)": config.host_rectify,
        "wire_bits<8 (wire packing, runtime/wire.py)": config.wire_bits != 8,
    }
    for what, asked in unported.items():
        if asked:
            raise NotImplementedError(f"{what} is not ported yet: see ROADMAP.md Queue 1")


class OCREngine:
    """Detector + recognizer + decode glue on one device."""

    def __init__(
        self,
        craft_params: Any,
        crnn_params: Any,
        config: EngineConfig = None,
        charset: Charset = EN_CHARSET,
        device="cuda",
    ):
        self.config = config if config is not None else EngineConfig()
        config = self.config
        _check_ported(config)
        tree = craft_params.get("params", {})
        if "slice1" in tree or "LiteBackbone_0" in tree:
            raise NotImplementedError(
                "published-layout CRAFT and CRAFTLite are not ported yet: see ROADMAP.md Queue 1"
            )
        self.device = torch.device(device)
        self.charset = charset
        dtype = config.compute_dtype
        # The detector takes the raw gray canvas: gray->RGB, /255 and the
        # ImageNet normalization are folded into its first conv.
        self.craft = CRAFT(gray_input=True)
        self.craft.load_state_dict(craft_state_dict(fold_gray_stem(craft_params)), strict=True)
        cast_for_compute(self.craft.to(self.device), dtype).eval()
        self.crnn = CRNN(num_classes=charset.num_classes)
        self.crnn.load_state_dict(crnn_state_dict(crnn_params), strict=True)
        cast_for_compute(self.crnn.to(self.device), dtype).eval()
        self._lock = threading.Lock()
        self.timers = StageTimer()

    @classmethod
    def from_checkpoint(
        cls, craft_path: str, crnn_path: str, config: EngineConfig = None,
        charset: Charset = None, device="cuda",
    ):
        """Charset defaults to the one the checkpoint's CTC head was trained with."""
        crnn_params = load_params(crnn_path)
        if charset is None:
            try:
                head = crnn_params["params"]["head"]["bias"]
                charset = charset_for_num_classes(int(head.shape[0]))
            except (KeyError, ValueError):
                charset = EN_CHARSET
        return cls(load_params(craft_path), crnn_params, config, charset, device=device)

    # ------------------------------------------------------------------
    # Device programs
    # ------------------------------------------------------------------

    @torch.no_grad()
    def detect(self, gray255: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W) float gray canvas in [0, 255] -> (mask u8, region u8),
        each (B, H/2, W/2), thresholded and quantized on the device."""
        maps = self.craft(gray255[:, None].to(self.config.compute_dtype))
        region, affinity = maps[:, 0], maps[:, 1]
        det = self.config.detection
        mask = (region > det.low_text) | (affinity > det.link_threshold)
        region_q = torch.clamp(torch.round(region * 255.0), 0, 255).to(torch.uint8)
        return mask.to(torch.uint8), region_q

    @torch.no_grad()
    def _decode(self, crops: torch.Tensor, lengths: torch.Tensor):
        x = (crops / 127.5 - 1.0)[:, None]
        logits = self.crnn(x.to(self.config.compute_dtype))
        return ctc_greedy_decode(logits, lengths)

    @torch.no_grad()
    def recognize(self, crops: torch.Tensor, lengths: torch.Tensor, valid: torch.Tensor):
        """(N, 32, W) crops in [0, 255] -> (ids, lens, conf). When some valid
        crop reads below ``contrast_ths``, the batch is re-read
        contrast-stretched and the better read kept per crop."""
        ids, lens, conf = self._decode(crops, lengths)
        ths = self.config.contrast_ths
        if ths <= 0:
            return ids, lens, conf
        worst = torch.where(valid, conf, torch.ones_like(conf)).min()
        if not bool(worst < ths):
            return ids, lens, conf
        ids2, lens2, conf2 = self._decode(_contrast_stretch(crops), lengths)
        better = (conf2 > conf) & (conf < ths) & valid
        return (
            torch.where(better[:, None], ids2, ids),
            torch.where(better, lens2, lens),
            torch.where(better, conf2, conf),
        )

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def readtext(self, image: np.ndarray) -> List[Tuple[np.ndarray, str, float]]:
        """Single image -> [(box (4,2) image coords, text, confidence)]."""
        return self.readtext_batch([image])[0]

    def readtext_batch(self, images: Sequence[np.ndarray]) -> List[List[Tuple[np.ndarray, str, float]]]:
        """Batched OCR over a list of grayscale/RGB uint8-or-float images."""
        if not images:
            return []
        with self._lock:
            ctx = self._stage_detect(images)
            self._stage_boxes_recognize(ctx)
            return self._stage_collect(ctx)

    def timings(self):
        """Per-stage wall-clock stats (letterbox/detect/boxes/rectify/
        recognize) accumulated since engine creation."""
        return self.timers.snapshot()

    # ------------------------------------------------------------------
    # Pipeline stages
    # ------------------------------------------------------------------

    def _stage_detect(self, images) -> Dict[str, Any]:
        cfg = self.config
        grays = [_to_gray_u8(img) for img in images]
        groups: Dict[CanvasSpec, List[int]] = {}
        for i, g in enumerate(grays):
            canvas = bucketing.pick_canvas(g.shape[0], g.shape[1], cfg.canvases)
            groups.setdefault(canvas, []).append(i)

        scales = [1.0] * len(images)
        canvas_batches: Dict[Tuple[CanvasSpec, int], torch.Tensor] = {}
        canvas_pos: Dict[int, Tuple[Tuple[CanvasSpec, int], int]] = {}
        pending = []
        for canvas, all_idxs in groups.items():
            for c in range(0, len(all_idxs), _CHUNK):
                idxs = all_idxs[c : c + _CHUNK]
                key = (canvas, c // _CHUNK)
                with self.timers.stage("letterbox"):
                    # uint8 on the wire, real rows only; widened and padded
                    # to the row menu on the device.
                    batch = np.zeros((len(idxs), canvas.height, canvas.width), np.uint8)
                    for slot, i in enumerate(idxs):
                        g = grays[i]
                        scale, oh, ow = bucketing.letterbox_params(g.shape[0], g.shape[1], canvas)
                        scales[i] = scale
                        batch[slot, :oh, :ow] = _host_resize(g, oh, ow)
                        canvas_pos[i] = (key, slot)
                    dev = torch.from_numpy(batch).to(self.device).to(torch.float32)
                    rows = bucketing.pad_count(len(idxs), _ROW_MENU)
                    if rows > dev.shape[0]:
                        dev = torch.cat([dev, dev.new_zeros((rows - dev.shape[0],) + dev.shape[1:])])
                    canvas_batches[key] = dev
                with self.timers.stage("detect"):
                    masks, regions = self.detect(dev)
                pending.append((idxs, masks, regions))
        return {
            "n_img": len(images), "scales": scales, "canvas_batches": canvas_batches,
            "canvas_pos": canvas_pos, "pending": pending,
        }

    def _stage_boxes_recognize(self, ctx: Dict[str, Any]) -> None:
        cfg = self.config
        det = cfg.detection
        per_image_quads: List[List[np.ndarray]] = [[] for _ in range(ctx["n_img"])]
        for idxs, masks_dev, regions_dev in ctx["pending"]:
            with self.timers.stage("detect"):
                masks = masks_dev.cpu().numpy()
                regions_q = regions_dev.cpu().numpy()
            with self.timers.stage("boxes"):
                for slot, i in enumerate(idxs):
                    qs = extract_boxes_masked(masks[slot], regions_q[slot], det)
                    if det.split_multiline:
                        qs = split_multiline_quads(
                            qs, regions_q[slot].astype(np.float32) / 255.0,
                            det.low_text, det.min_size_px,
                        )
                    # map coords (maps are canvas / 2) -> canvas coords
                    per_image_quads[i] = [q * 2.0 for q in qs]
        ctx["per_image_quads"] = per_image_quads

        buckets: Dict[int, List[Tuple[int, int, np.ndarray, int]]] = {}
        for i, quads in enumerate(per_image_quads):
            for j, quad in enumerate(quads):
                true_w, bucket_w = bucketing.crop_width_for_quad(quad, cfg.width_buckets)
                buckets.setdefault(bucket_w, []).append((i, j, quad, true_w))
        if len(buckets) > 1 and ctx["n_img"] < cfg.merge_buckets_below:
            merged = [e for entries in buckets.values() for e in entries]
            buckets = {max(buckets): merged}

        dispatched = []
        for bucket_w, entries in buckets.items():
            cap = bucketing.pad_count(len(entries), cfg.batch_capacities)
            by_canvas: Dict[Tuple[CanvasSpec, int], List[int]] = {}
            for e_idx, (i, _, _, _) in enumerate(entries):
                by_canvas.setdefault(ctx["canvas_pos"][i][0], []).append(e_idx)
            crop_arrays = []
            order: List[int] = []
            for src_key, e_idxs in by_canvas.items():
                # crop count padded to a power of two, as in the JAX engine
                n_pad = 1 << (max(1, len(e_idxs)) - 1).bit_length()
                homos = np.zeros((n_pad, 3, 3), np.float32)
                img_idx = np.zeros(n_pad, np.int64)
                true_ws = np.ones(n_pad, np.int64)
                for k, e_idx in enumerate(e_idxs):
                    i, _, quad, true_w = entries[e_idx]
                    homos[k] = quad_to_rect_homography(quad, true_w)
                    img_idx[k] = ctx["canvas_pos"][i][1]
                    true_ws[k] = true_w
                with self.timers.stage("rectify"):
                    crops = warp_crops(
                        ctx["canvas_batches"][src_key],
                        torch.from_numpy(homos).to(self.device),
                        torch.from_numpy(img_idx).to(self.device),
                        torch.from_numpy(true_ws).to(self.device),
                        bucket_w,
                    )[: len(e_idxs)]
                crop_arrays.append(crops)
                order.extend(e_idxs)
            all_crops = torch.cat(crop_arrays) if len(crop_arrays) > 1 else crop_arrays[0]
            dispatched.append(self._recognize_dispatch(entries, order, all_crops, cap))
        ctx["dispatched"] = dispatched
        ctx["canvas_batches"] = None

    def _recognize_dispatch(self, entries, order, all_crops: torch.Tensor, cap: int):
        """Pad a bucket's crops and lengths to capacity and recognize."""
        lengths = np.zeros(cap, np.int64)
        lengths[: len(order)] = [entries[e][3] // 4 - 1 for e in order]
        n = all_crops.shape[0]
        if cap > n:
            all_crops = torch.cat([all_crops, all_crops.new_zeros((cap - n,) + all_crops.shape[1:])])
        valid = np.zeros(cap, bool)
        valid[: len(order)] = True
        with self.timers.stage("recognize"):
            ids, lens, conf = self.recognize(
                all_crops,
                torch.from_numpy(np.maximum(lengths, 1)).to(self.device),
                torch.from_numpy(valid).to(self.device),
            )
        return entries, order, ids, lens, conf

    def _stage_collect(self, ctx: Dict[str, Any]) -> List[List[Tuple[np.ndarray, str, float]]]:
        cfg = self.config
        texts: Dict[Tuple[int, int], Tuple[str, float]] = {}
        for entries, order, ids, lens, conf in ctx["dispatched"]:
            with self.timers.stage("recognize"):
                ids = ids.cpu().numpy()
                lens = lens.cpu().numpy()
                conf = conf.cpu().numpy()
            for k, e_idx in enumerate(order):
                i, j, _, _ = entries[e_idx]
                texts[(i, j)] = (self.charset.decode_ids(ids[k][: lens[k]]), float(conf[k]))
        results = []
        for i, quads in enumerate(ctx["per_image_quads"]):
            out = []
            for j in sort_reading_order(quads):
                text, c = texts.get((i, j), ("", 0.0))
                if c < cfg.min_confidence or not text:
                    continue
                out.append((quads[j] / max(ctx["scales"][i], 1e-9), text, c))
            results.append(out)
        return results


def _contrast_stretch(crops: torch.Tensor, lo_pct: float = 10.0, hi_pct: float = 90.0) -> torch.Tensor:
    """Percentile contrast stretch per crop (N, H, W) -> full [0,255] range.
    ``torch.quantile`` interpolates linearly, as ``jnp.percentile`` does."""
    q = torch.tensor([lo_pct / 100.0, hi_pct / 100.0], device=crops.device, dtype=crops.dtype)
    lo, hi = torch.quantile(crops.reshape(crops.shape[0], -1), q, dim=1)[:, :, None, None]
    scale = 255.0 / torch.clamp(hi - lo, min=1.0)
    return torch.clamp((crops - lo) * scale, 0.0, 255.0)


# cv2 COLOR_RGB2GRAY fixed point: Y = (R*9798 + G*19235 + B*3735 + 2^14) >> 15
_GRAY_COEFFS = np.array([9798, 19235, 3735], np.int32)


def _to_gray_u8(img) -> np.ndarray:
    """Any input image -> (H, W) uint8 grayscale, as the JAX engine computes
    it with cv2: uint8 RGB in cv2's fixed point, floats truncated."""
    arr = img.cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
    if arr.ndim == 3:
        if arr.dtype == np.uint8:
            y = (arr[..., :3].astype(np.int32) @ _GRAY_COEFFS + (1 << 14)) >> 15
            return y.astype(np.uint8)
        arr = 0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr


def _linear_coeffs(n_out: int, n_in: int, clamp_frac: bool):
    """cv2 INTER_LINEAR source indices and 11-bit weights along one axis.

    Horizontally cv2 clamps the sample position (fraction 0 at the edges);
    vertically it keeps the fraction and clamps the row indices.
    """
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_frac:
        f[s < 0] = 0
        s[s < 0] = 0
        f[s >= n_in - 1] = 0
        s[s >= n_in - 1] = n_in - 1
    w1 = np.rint(f * 2048).astype(np.int64)
    w0 = np.rint((1 - f) * 2048).astype(np.int64)
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), w0, w1


def _host_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(INTER_LINEAR) of a uint8 gray image, bit for bit.

    cv2's fixed point: 11-bit weights, an exact integer horizontal pass,
    and a vertical pass that (in its SIMD form) takes ``(row >> 4) * w >> 16``
    per row and stores ``(sum + 2) >> 2``.
    """
    u8 = img if img.dtype == np.uint8 else np.clip(img, 0, 255).astype(np.uint8)
    src = u8.astype(np.int64)
    x0, x1, ax0, ax1 = _linear_coeffs(out_w, src.shape[1], True)
    y0, y1, ay0, ay1 = _linear_coeffs(out_h, src.shape[0], False)
    rows = src[:, x0] * ax0 + src[:, x1] * ax1
    v = (((rows[y0] >> 4) * ay0[:, None]) >> 16) + (((rows[y1] >> 4) * ay1[:, None]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)
