"""The OCR engine: photo(s) -> [(quad, text, confidence)].

Counterpart of ``bbocr_tpu/runtime/engine.py::OCREngine`` on one device:

- letterbox each photo onto a canvas from the menu (host, uint8, cv2's
  fixed-point bilinear resize), uploaded as uint8 or, with ``wire_bits``
  below 8, dithered and bit-packed (``runtime/wire.py``) and unpacked on
  the device;
- detect: CRAFT (or CRAFTLite) with the folded gray stem, or the unfolded
  RGB stem (always for the published layout),
  optionally on an average-pooled canvas (``detect_pool``) and with a
  second, coarse pass over the same canvas (``detect_coarse``), thresholds
  applied on the device, two uint8 planes downloaded per canvas;
- boxes: the C++ labeler on the host, then the multi-line split;
- rectify: by default on the host, each crop warped from the original
  gray photo (``runtime/wire.py``, the C++ warp) and uploaded as uint8;
  with ``host_rectify=False``, one bilinear gather warp per width bucket on
  the device from the letterboxed canvas;
- recognize: CRNN + greedy (or prefix beam) CTC on the device, with the
  contrast-stretch retry for low-confidence crops;
- collect in reading order, back in image coordinates.

Besides ``readtext``: the three-stage pipeline over a stream of batches
(``readtext_stream``), the single-dispatch fast path (``readtext_fast``,
``runtime/fastpath.py``), the full-resolution re-reads (``lines_logits``,
``reread_low_conf`` with the device beam, ``reread_isbn`` with the
digit-biased host beam), ``warmup`` and the text helpers ``read_joined``
and ``read_lines``. The detector follows the checkpoint's layout: CRAFT,
``CRAFTLite`` or the published ``CRAFTPublished`` (``type(engine.craft)``).
The letterbox fills and host warps run on a process-wide pool of 8
threads, as in the JAX engine; the box extraction runs in a loop.

With a ``mesh`` (``parallel/mesh.py``, a (dp, tp) ``DeviceMesh``) serving
runs SPMD: every rank makes the same calls with the same photos, and the
host stages run replicated. Photo rows and crop batches are padded to dp
multiples where the JAX engine pads them, each dp rank detects and
recognizes its contiguous block of rows, and the blocks are all-gathered,
so every rank returns the whole result. The widest weights
(``parallel/sharding.py::param_shardings``) are split over tp, each rank
keeping its slice, and their products gather their output channels.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bbocr_tpu_torch.decode import (
    DetectionParams,
    ctc_greedy_decode,
    extract_boxes_masked,
    group_lines,
    merge_coarse_quads,
    sort_reading_order,
    split_multiline_quads,
)
from bbocr_tpu_torch.decode.beam_device import ctc_beam_decode_device
from bbocr_tpu_torch.models import (
    CRAFT,
    CRNN,
    CRAFTLite,
    CRAFTPublished,
    EN_CHARSET,
    Charset,
    cast_for_compute,
    charset_for_num_classes,
    craft_state_dict,
    crnn_state_dict,
    fold_gray_stem,
)
from bbocr_tpu_torch.models.craft import IMAGENET_MEAN, IMAGENET_STD
from bbocr_tpu_torch.models.crnn import INPUT_HEIGHT
from bbocr_tpu_torch.parallel.collectives import all_gather_cat
from bbocr_tpu_torch.runtime import bucketing
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec
from bbocr_tpu_torch.runtime.fastpath import fast_readtext_program
from bbocr_tpu_torch.runtime.rectify import quad_to_rect_homography, warp_crops
from bbocr_tpu_torch.runtime.wire import host_warp_crop, pack_canvas, unpack_widen
from bbocr_tpu_torch.utils.checkpoint import load_params
from bbocr_tpu_torch.utils import profiling
from bbocr_tpu_torch.utils.profiling import StageTimer, span

_INV_127_5 = float(np.float32(1.0 / 127.5))

# Photos per detect batch; a batch's row count is padded to this menu.
_CHUNK = 8
_ROW_MENU = (1, 2, 4, _CHUNK)

_STREAM_END = object()


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
    # Fast path (readtext_fast): max component boxes per canvas and its one
    # recognition width bucket.
    fast_max_boxes: int = 24
    fast_bucket_w: int = 256
    # torch.bfloat16 or torch.float32 for the CRAFT and CRNN forwards.
    compute_dtype: torch.dtype = torch.bfloat16
    # Requests of fewer images than this merge all width buckets into the
    # widest one needed.
    merge_buckets_below: int = 2
    # Fold gray->RGB, /255 and the ImageNet normalization into CRAFT's first
    # conv (models.weights.fold_gray_stem); False runs the RGB stem.
    fold_gray_stem: bool = True
    # Average-pool factor applied on the device to canvases of at least
    # detect_pool_min_area pixels before CRAFT (1 = off); crops are still
    # rectified from the full canvas.
    detect_pool: int = 1
    detect_pool_min_area: int = 1408 * 1024
    # The knobs below are read from the environment when the config is
    # constructed, not when this module is imported.
    # Canvas upload bit depth (8, 4, 2 or 1): below 8 the canvas ships
    # dithered and bit-packed and is unpacked on the device (runtime/wire.py).
    wire_bits: int = field(default_factory=lambda: int(os.environ.get("BB_OCR_WIRE_BITS", "8")))
    # CTC decoder of the recognize program: "greedy", or "beam" (the device
    # prefix beam, decode/beam_device.py; confidence exp(prefix log-prob)).
    decoder: str = field(default_factory=lambda: os.environ.get("BB_OCR_DECODER", "greedy"))
    # Pool factor of an additional coarse detect pass over the same canvas
    # (0 or 1 = off); its giant quads are merged in where the fine pass has
    # no answer (decode/boxes.py::merge_coarse_quads).
    detect_coarse: int = field(default_factory=lambda: int(os.environ.get("BB_OCR_DETECT_COARSE", "0")))
    # Warp recognition crops on the host from the original photo (True, as
    # in the JAX engine), or on the device from the letterboxed canvas.
    host_rectify: bool = field(
        default_factory=lambda: os.environ.get("BB_OCR_HOST_RECTIFY", "1").lower() not in ("0", "", "false")
    )


class OCREngine:
    """Detector + recognizer + decode glue on one device."""

    def __init__(
        self,
        craft_params: Any,
        crnn_params: Any,
        config: EngineConfig = None,
        charset: Charset = EN_CHARSET,
        device="cuda",
        mesh: Any = None,
    ):
        """``mesh``: optional (dp, tp) ``DeviceMesh`` (``parallel/mesh.py``);
        the engine then serves SPMD over it on this rank's device: its card
        (``cuda:<local rank>``) for a ``"cuda"`` device, the CPU only when
        asked, matching the mesh's device type."""
        self.config = config if config is not None else EngineConfig()
        config = self.config
        if config.wire_bits not in (1, 2, 4, 8):
            raise ValueError(f"wire_bits must be 1, 2, 4, or 8 (got {config.wire_bits})")
        self.mesh = mesh
        self._dp = mesh.size(0) if mesh is not None else 1
        self.device = _rank_device(device, mesh) if mesh is not None else torch.device(device)
        self.charset = charset
        dtype = config.compute_dtype
        # Parameter-tree sniffing, as in the JAX engine: an imported published
        # tree ("slice1") runs the published dataflow, a "LiteBackbone_0"
        # tree the slim detector, any other tree CRAFT. With the folded stem
        # (not for the published layout) the detector takes the raw gray
        # canvas: gray->RGB, /255 and the ImageNet normalization are folded
        # into its first conv.
        tree = craft_params.get("params", {})
        published = "slice1" in tree
        self._fold = bool(config.fold_gray_stem) and not published
        if published:
            self.craft = CRAFTPublished()
        elif "LiteBackbone_0" in tree:
            self.craft = CRAFTLite(gray_input=self._fold)
        else:
            self.craft = CRAFT(gray_input=self._fold)
        stem_params = fold_gray_stem(craft_params) if self._fold else craft_params
        self.craft.load_state_dict(craft_state_dict(stem_params), strict=True)
        cast_for_compute(self.craft.to(self.device), dtype).eval()
        self.crnn = CRNN(num_classes=charset.num_classes)
        self.crnn.load_state_dict(crnn_state_dict(crnn_params), strict=True)
        cast_for_compute(self.crnn.to(self.device), dtype).eval()
        if mesh is not None:
            from bbocr_tpu_torch.parallel.sharding import shard_module

            shard_module(self.craft, mesh)
            shard_module(self.crnn, mesh)
        # tensor operands: CUDA divides by a Python number as a multiply by
        # its reciprocal, which is not the JAX engine's division
        self._255 = torch.tensor(255.0, device=self.device)
        self._mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=self.device)[:, None, None]
        self._std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=self.device)[:, None, None]
        self._lock = threading.Lock()
        self.timers = StageTimer()

    @classmethod
    def create(
        cls, seed: int = 0, config: EngineConfig = None, charset: Charset = EN_CHARSET,
        mesh: Any = None, device="cuda",
    ):
        """Engine with freshly initialised (untrained) parameters: flax's
        initialisers drawn from a ``torch.Generator`` seeded with ``seed``
        (``models/init.py``; the values are not ``jax.random``'s)."""
        from bbocr_tpu_torch.models.init import init_engine_params

        craft_params, crnn_params = init_engine_params(seed, charset.num_classes)
        return cls(craft_params, crnn_params, config, charset, device=device, mesh=mesh)

    @classmethod
    def from_checkpoint(
        cls, craft_path: str, crnn_path: str, config: EngineConfig = None,
        charset: Charset = None, device="cuda", mesh: Any = None,
    ):
        """Charset defaults to the one the checkpoint's CTC head was trained with."""
        crnn_params = load_params(crnn_path)
        if charset is None:
            try:
                head = crnn_params["params"]["head"]["bias"]
                charset = charset_for_num_classes(int(head.shape[0]))
            except (KeyError, ValueError):
                charset = EN_CHARSET
        return cls(load_params(craft_path), crnn_params, config, charset, device=device, mesh=mesh)

    # ------------------------------------------------------------------
    # Device programs
    # ------------------------------------------------------------------

    def craft_input(self, gray255: torch.Tensor) -> torch.Tensor:
        """(B, H, W) float gray canvas in [0, 255] -> CRAFT's input in the
        compute type: the gray plane for the folded stem, else gray repeated
        to RGB, divided by 255 and ImageNet-normalized."""
        x = gray255[:, None]
        if not self._fold:
            x = (x.expand(-1, 3, -1, -1) / self._255 - self._mean) / self._std
        return x.to(self.config.compute_dtype)

    @torch.no_grad()
    def detect(self, gray255: torch.Tensor, pool: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W) float gray canvas in [0, 255] -> (mask u8, region u8),
        each (B, H/2p, W/2p), thresholded and quantized on the device.
        ``pool`` average-pools the canvas first (a mean of at most 16 uint8
        values over a power of two, exact in float32)."""
        if pool > 1:
            b, h, w = gray255.shape
            gray255 = gray255.reshape(b, h // pool, pool, w // pool, pool).mean((2, 4))
        maps = self.craft(self.craft_input(gray255))
        region, affinity = maps[:, 0], maps[:, 1]
        det = self.config.detection
        mask = (region > det.low_text) | (affinity > det.link_threshold)
        region_q = torch.clamp(torch.round(region * 255.0), 0, 255).to(torch.uint8)
        return mask.to(torch.uint8), region_q

    @torch.no_grad()
    def recognizer_logits(self, crops: torch.Tensor) -> torch.Tensor:
        """(N, 32, W) crops in [0, 255] -> (N, T, C) CRNN logits."""
        x = _to_unit_range(crops)[:, None]
        return self.crnn(x.to(self.config.compute_dtype))

    @torch.no_grad()
    def _decode(self, crops: torch.Tensor, lengths: torch.Tensor):
        logits = self.recognizer_logits(crops)
        if self.config.decoder == "beam":
            ids, lens, score = ctc_beam_decode_device(logits, lengths)
            return ids, lens, torch.exp(score)
        return ctc_greedy_decode(logits, lengths)

    @torch.no_grad()
    def recognize(self, crops: torch.Tensor, lengths: torch.Tensor, valid: torch.Tensor):
        """(N, 32, W) crops in [0, 255] -> (ids, lens, conf). When some valid
        crop reads below ``contrast_ths``, the batch is re-read
        contrast-stretched and the better read kept per crop."""
        with span("crnn", reread=False):
            ids, lens, conf = self._decode(crops, lengths)
        ths = self.config.contrast_ths
        if ths <= 0:
            return ids, lens, conf
        worst = torch.where(valid, conf, torch.ones_like(conf)).min()
        with span("download", check="reread"):  # waits for the read above
            low = bool(worst < ths)
        if not low:
            return ids, lens, conf
        with span("crnn", reread=True):
            ids2, lens2, conf2 = self._decode(_contrast_stretch(crops), lengths)
        better = (conf2 > conf) & (conf < ths) & valid
        return (
            torch.where(better[:, None], ids2, ids),
            torch.where(better, lens2, lens),
            torch.where(better, conf2, conf),
        )

    def _dp_rows(self, fn, *rows: torch.Tensor):
        """``fn(*rows)`` on the whole rows without a mesh; under one, on this
        rank's contiguous block of rows of its dp group (the row count is a
        dp multiple), the outputs' blocks all-gathered in dp order."""
        if self.mesh is None:
            return fn(*rows)
        k = rows[0].shape[0] // self._dp
        r = self.mesh.get_local_rank("dp")
        outs = fn(*(x[r * k : (r + 1) * k] for x in rows))
        group = self.mesh.get_group("dp")
        return tuple(all_gather_cat(o, 0, group, self._dp) for o in outs)

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
        with self._lock, profiling.batch():
            ctx = self._stage_detect(images)
            self._stage_boxes_recognize(ctx)
            return self._stage_collect(ctx)

    def readtext_stream(self, batches, depth: int = 2):
        """Pipelined serving over an iterable of image lists; yields each
        batch's results in order, equal to :meth:`readtext_batch` on it.

        Three stages run on separate host threads so that consecutive
        batches overlap: while batch k is in host box extraction and crop
        dispatch, or in text decoding, batch k+1's letterbox and detect are
        issued. All stages issue their device work on the current CUDA
        stream. ``depth`` bounds the batches in flight (each holds its
        canvases on the device until its crops are dispatched); an empty
        batch yields ``[]``; an error in a stage is raised in the consumer
        after the batches done before it. Under a mesh the stages' collectives
        must follow one order on every rank, so the batches are read in
        turn on the consumer's thread (``readtext_batch`` each).

        A consumer that stops early (``close()``, an exception) stops the
        stages: detect takes no further batch, the middle stage lets the
        rest pass undone, and the consumer drains only the output queue, so
        that each stage's end marker reaches the stage that waits for it.
        (The JAX engine's stream drains both queues and can take the detect
        stage's end marker from the middle stage, which then waits forever.)
        """
        # (``getattr``: the stream's thread protocol also runs on stand-ins
        # that carry only the three stages and the lock)
        if getattr(self, "mesh", None) is not None:
            for imgs in batches:
                yield self.readtext_batch(imgs) if imgs else []
            return
        with self._lock:
            q_mid: Any = queue.Queue(maxsize=depth)
            q_out: Any = queue.Queue(maxsize=depth)
            err: List[BaseException] = []
            stop = threading.Event()

            # a batch travels with its sequence number, which the spans of
            # all three threads carry
            def t_detect():
                try:
                    for imgs in batches:
                        if stop.is_set():
                            break
                        with profiling.batch() as number:
                            ctx = self._stage_detect(imgs) if imgs else None
                            with span("stream.wait", queue="q_mid", op="put"):
                                q_mid.put((number, ctx))
                except BaseException as e:  # raised in the consumer
                    err.append(e)
                finally:
                    q_mid.put(_STREAM_END)

            def t_mid():
                try:
                    while True:
                        with span("stream.wait", queue="q_mid", op="get"):
                            item = q_mid.get()
                        if item is _STREAM_END:
                            break
                        if stop.is_set():
                            continue  # stopped: let the detect stage run out
                        number, ctx = item
                        with profiling.batch(number):
                            try:
                                if ctx is not None:
                                    self._stage_boxes_recognize(ctx)
                            except BaseException as e:
                                err.append(e)
                                stop.set()
                                continue
                            with span("stream.wait", queue="q_out", op="put"):
                                q_out.put(item)
                finally:
                    q_out.put(_STREAM_END)

            threads = [threading.Thread(target=t_detect, daemon=True), threading.Thread(target=t_mid, daemon=True)]
            for t in threads:
                t.start()
            try:
                while True:
                    with span("stream.wait", queue="q_out", op="get"):
                        item = q_out.get()
                    if item is _STREAM_END:
                        break
                    number, ctx = item
                    with profiling.batch(number):  # closed before the yield
                        res = [] if ctx is None else self._stage_collect(ctx)
                    yield res
            finally:
                stop.set()
                while any(t.is_alive() for t in threads):
                    try:
                        q_out.get(timeout=0.005)
                    except queue.Empty:
                        pass
                for t in threads:
                    t.join()
            if err:
                raise err[0]

    def warmup(self, images: Any = None) -> int:
        """Run the serving menu once so that real traffic does not pay the
        first call of a shape: one batch call over ``images``, then one
        single call each (single calls merge width buckets, so their shapes
        differ). ``images`` defaults to one uniform-noise gray image per
        configured canvas, from ``np.random.default_rng(0)``. On a card the
        calls set up cuDNN for each canvas's detector shapes and load the
        CUDA modules the path needs. Returns the number of calls made."""
        if images is None:
            rng = np.random.default_rng(0)
            images = [rng.uniform(0, 255, (c.height, c.width)).astype(np.float32) for c in self.config.canvases]
        self.readtext_batch(list(images))
        for img in images:
            self.readtext(img)
        return 1 + len(images)

    def timings(self):
        """Per-stage wall-clock stats (letterbox/detect/boxes/rectify/
        recognize) accumulated since engine creation."""
        return self.timers.snapshot()

    def read_joined(self, image: np.ndarray) -> str:
        """The texts joined with spaces in reading order."""
        return " ".join(t for _, t, _ in self.readtext(image))

    def read_lines(self, image: np.ndarray) -> List[str]:
        """The texts grouped into visual lines."""
        res = self.readtext(image)
        if not res:
            return []
        return [" ".join(res[i][1] for i in line) for line in group_lines([r[0] for r in res])]

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
                    # uint8 (or bit-packed) on the wire, real rows only;
                    # padded to the row menu and widened on the device
                    batch = np.zeros((len(idxs), canvas.height, canvas.width), np.uint8)

                    def fill(slot_i):  # mapped before the loop moves on
                        slot, i = slot_i
                        g = grays[i]
                        scale, oh, ow = bucketing.letterbox_params(g.shape[0], g.shape[1], canvas)
                        scales[i] = scale
                        batch[slot, :oh, :ow] = _host_resize(g, oh, ow)
                        canvas_pos[i] = (key, slot)

                    _host_map(fill, list(enumerate(idxs)))
                    packed = torch.from_numpy(pack_canvas(batch, cfg.wire_bits))
                    with span("upload"):
                        raw = packed.to(self.device)
                    rows = bucketing.pad_count(len(idxs), _ROW_MENU)
                    rows = -(-rows // self._dp) * self._dp  # dp-divisible under a mesh
                    if rows > raw.shape[0]:
                        raw = torch.cat([raw, raw.new_zeros((rows - raw.shape[0],) + raw.shape[1:])])
                    dev = unpack_widen(raw, cfg.wire_bits)
                    canvas_batches[key] = dev
                pool = (
                    cfg.detect_pool
                    if cfg.detect_pool > 1 and canvas.height * canvas.width >= cfg.detect_pool_min_area
                    else 1
                )
                with self.timers.stage("detect"), span("craft"):
                    masks, regions = self._dp_rows(lambda g: self.detect(g, pool), dev)
                    coarse = None
                    if cfg.detect_coarse > 1 and pool == 1:
                        # a second pass over the same device canvas at 1/p
                        coarse = self._dp_rows(lambda g: self.detect(g, cfg.detect_coarse), dev) + (cfg.detect_coarse,)
                pending.append((idxs, masks, regions, pool, coarse))
        return {
            "n_img": len(images), "scales": scales, "canvas_batches": canvas_batches,
            "canvas_pos": canvas_pos, "pending": pending,
            # host rectification samples crops from the original pixels
            "grays": grays if cfg.host_rectify else None,
        }

    def _stage_boxes_recognize(self, ctx: Dict[str, Any]) -> None:
        cfg = self.config
        det = cfg.detection
        per_image_quads: List[List[np.ndarray]] = [[] for _ in range(ctx["n_img"])]

        def quads_from(mask, region_q, pool):
            qs = extract_boxes_masked(mask, region_q, det)
            if det.split_multiline:
                qs = split_multiline_quads(qs, region_q.astype(np.float32) / 255.0, det.low_text, det.min_size_px)
            # map coords (maps are canvas / (2 pool)) -> canvas coords
            return [q * (2.0 * pool) for q in qs]

        for idxs, masks_dev, regions_dev, pool, coarse in ctx["pending"]:
            with self.timers.stage("detect"), span("download"):
                masks = masks_dev.cpu().numpy()
                regions_q = regions_dev.cpu().numpy()
                if coarse is not None:
                    coarse = (coarse[0].cpu().numpy(), coarse[1].cpu().numpy(), coarse[2])
            # in a loop on this thread, unlike the JAX engine: the extraction's
            # Python holds the GIL, and on the host pool it slowed the stream
            # (PERF.md, Findings)
            with self.timers.stage("boxes"):
                for slot, i in enumerate(idxs):
                    quads = quads_from(masks[slot], regions_q[slot], pool)
                    if coarse is not None:
                        quads = merge_coarse_quads(quads, quads_from(coarse[0][slot], coarse[1][slot], coarse[2]))
                    per_image_quads[i] = quads
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
            cap = -(-cap // self._dp) * self._dp  # dp-divisible under a mesh
            if cfg.host_rectify:
                # each crop warped from the original gray at native detail,
                # uploaded as uint8 and widened on the device
                crop_buf = np.zeros((cap, INPUT_HEIGHT, bucket_w), np.uint8)

                def warp(k_entry):  # mapped before the loop moves on
                    k, (i, _, quad, true_w) = k_entry
                    oq = np.asarray(quad, np.float64) / max(ctx["scales"][i], 1e-9)
                    crop_buf[k] = host_warp_crop(
                        ctx["grays"][i], oq, true_w, INPUT_HEIGHT, bucket_w, quad_to_rect_homography)

                with self.timers.stage("rectify"):
                    _host_map(warp, list(enumerate(entries)))
                    with span("upload"):
                        all_crops = torch.from_numpy(crop_buf).to(self.device)
                    all_crops = all_crops.to(torch.float32)
                dispatched.append(self._recognize_dispatch(entries, list(range(len(entries))), all_crops, cap))
                continue
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
                    with span("upload"):
                        homos, img_idx, true_ws = (torch.from_numpy(a).to(self.device) for a in (homos, img_idx, true_ws))
                    crops = warp_crops(ctx["canvas_batches"][src_key], homos, img_idx, true_ws, bucket_w)[: len(e_idxs)]
                crop_arrays.append(crops)
                order.extend(e_idxs)
            all_crops = torch.cat(crop_arrays) if len(crop_arrays) > 1 else crop_arrays[0]
            dispatched.append(self._recognize_dispatch(entries, order, all_crops, cap))
        ctx["dispatched"] = dispatched
        # The dispatched warps hold what they need: drop the canvases, so
        # that batches in flight in readtext_stream free device memory.
        ctx["canvas_batches"] = ctx["pending"] = ctx["grays"] = None

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
            with span("upload"):
                lengths = torch.from_numpy(np.maximum(lengths, 1)).to(self.device)
                valid = torch.from_numpy(valid).to(self.device)
            ids, lens, conf = self._dp_rows(self.recognize, all_crops, lengths, valid)
        return entries, order, ids, lens, conf

    def _stage_collect(self, ctx: Dict[str, Any]) -> List[List[Tuple[np.ndarray, str, float]]]:
        cfg = self.config
        texts: Dict[Tuple[int, int], Tuple[str, float]] = {}
        for entries, order, ids, lens, conf in ctx["dispatched"]:
            with self.timers.stage("recognize"), span("download"):
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

    # ------------------------------------------------------------------
    # Single-dispatch fast path
    # ------------------------------------------------------------------

    def readtext_fast(self, image: np.ndarray) -> List[Tuple[np.ndarray, str, float]]:
        """One device program per photo: detect -> device CC labeling ->
        top-K axis-aligned boxes -> warp -> recognize -> greedy decode, with
        one canvas upload and one small download. Output as :meth:`readtext`;
        boxes are axis-aligned."""
        cfg = self.config
        arr = _to_gray_u8(image)
        canvas = bucketing.pick_canvas(arr.shape[0], arr.shape[1], cfg.canvases)
        scale, oh, ow = bucketing.letterbox_params(arr.shape[0], arr.shape[1], canvas)
        batch = np.zeros((1, canvas.height, canvas.width), np.uint8)
        batch[0, :oh, :ow] = _host_resize(arr, oh, ow)
        packed = pack_canvas(batch, cfg.wire_bits)
        with self._lock, self.timers.stage("fast"):
            with span("upload"):
                raw = torch.from_numpy(packed).to(self.device)
            gray = unpack_widen(raw, cfg.wire_bits)
            out = fast_readtext_program(self, gray, cfg.fast_max_boxes, cfg.fast_bucket_w)
            with span("download"):
                boxes, ids, lens, conf, valid = (a.cpu().numpy() for a in out)

        quads, entries = [], []
        for i in range(len(valid)):
            if not valid[i]:
                continue
            text = self.charset.decode_ids(ids[i][: lens[i]])
            if not text or conf[i] < cfg.min_confidence:
                continue
            x0, y0, x1, y1 = boxes[i]
            quad = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32) / max(scale, 1e-9)
            quads.append(quad)
            entries.append((quad, text, float(conf[i])))
        return [entries[j] for j in sort_reading_order(quads)]

    # ------------------------------------------------------------------
    # Full-resolution re-reads
    # ------------------------------------------------------------------

    def lines_logits(self, image: np.ndarray, quads, bucket_w: int = 384):
        """Recognition logits for quads re-sampled from the full-resolution
        image: a host crop of the region around each quad on a 128x1024
        canvas, all warped and recognized in one batch on the device.
        Returns (logits (N, T, C) float32, frames (N,) valid frame counts).
        No contrast retry, as in the JAX engine's program."""
        roi_h, roi_w = 128, 1024
        arr = np.asarray(image, np.float32)
        if arr.ndim == 3:
            arr = 0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
        n = len(quads)
        n_pad = bucketing.pad_count(n, (1, 2, 4, 8))
        canvas = np.zeros((n_pad, roi_h, roi_w), np.float32)
        homos = np.zeros((n_pad, 3, 3), np.float32)
        true_ws = np.ones(n_pad, np.int64)
        for k, quad in enumerate(quads):
            q = np.asarray(quad, np.float64)
            margin = 8.0
            x0 = max(0, int(np.floor(q[:, 0].min() - margin)))
            y0 = max(0, int(np.floor(q[:, 1].min() - margin)))
            x1 = min(arr.shape[1], int(np.ceil(q[:, 0].max() + margin)))
            y1 = min(arr.shape[0], int(np.ceil(q[:, 1].max() + margin)))
            roi = arr[y0:y1, x0:x1]
            if roi.size == 0:
                roi = arr
                x0 = y0 = 0
            rh, rw = roi.shape
            scale = min(1.0, roi_h / rh, roi_w / rw)
            if scale < 1.0:
                roi = _host_resize(roi, max(1, int(rh * scale)), max(1, int(rw * scale)))
            canvas[k, : roi.shape[0], : roi.shape[1]] = roi
            qq = (q - [x0, y0]) * scale
            w_src = max(np.linalg.norm(qq[1] - qq[0]), np.linalg.norm(qq[2] - qq[3]))
            h_src = max(np.linalg.norm(qq[3] - qq[0]), np.linalg.norm(qq[2] - qq[1]))
            true_ws[k] = int(np.clip(round(INPUT_HEIGHT * w_src / max(h_src, 1e-6)), 8, bucket_w))
            homos[k] = quad_to_rect_homography(qq, true_ws[k])
        with self._lock:
            crops = warp_crops(
                torch.from_numpy(canvas).to(self.device), torch.from_numpy(homos).to(self.device),
                torch.arange(n_pad, device=self.device), torch.from_numpy(true_ws).to(self.device), bucket_w,
            )
            logits = self.recognizer_logits(crops)[:n].float().cpu().numpy()
        frames = np.maximum(true_ws[:n] // 4 - 1, 1)
        return logits, frames

    def isbn_logits(self, image: np.ndarray, quad: np.ndarray, bucket_w: int = 384):
        """Single-quad full-resolution logits (see :meth:`lines_logits`)."""
        logits, frames = self.lines_logits(image, [quad], bucket_w)
        return logits[0], int(frames[0])

    def reread_low_conf(self, image: np.ndarray, results, *, conf_ths: float = 0.5,
                        max_rereads: int = 8, bucket_w: int = 384, beam_width: int = 8):
        """Re-read every result under ``conf_ths`` (lowest first, at most
        ``max_rereads``) from the original pixels, decoded with the device
        prefix beam in one batch; the reading with the better per-character
        geometric-mean confidence wins. Returns a new list (same quads and
        order)."""
        idxs = [i for i, (_, t, c) in enumerate(results) if c < conf_ths and t]
        idxs.sort(key=lambda i: results[i][2])
        idxs = idxs[:max_rereads]
        if not idxs:
            return list(results)
        logits, frames = self.lines_logits(image, [results[i][0] for i in idxs], bucket_w)
        b_ids, b_lens, _ = ctc_beam_decode_device(
            torch.from_numpy(logits).to(self.device), torch.from_numpy(frames).to(self.device),
            beam_width=beam_width, max_len=48,
        )
        b_ids, b_lens = b_ids.cpu().numpy(), b_lens.cpu().numpy()
        out = list(results)
        for k, i in enumerate(idxs):
            quad, text, conf = results[i]
            lp = logits[k, : frames[k]].astype(np.float64)
            m = lp.max(-1, keepdims=True)
            lp = lp - (m + np.log(np.exp(lp - m).sum(-1, keepdims=True)))
            text2 = self.charset.decode_ids(b_ids[k][: b_lens[k]])
            # greedy-path confidence of the re-read (the product the first
            # read carries)
            best = lp.argmax(-1)
            prev = np.concatenate([[-1], best[:-1]])
            keep = (best != 0) & (best != prev)
            conf2 = float(np.exp(lp.max(-1)[keep].sum())) if keep.any() else 0.0
            # products shrink with emitted length: compare per-character
            # geometric means so wider re-read crops are not penalized
            n1, n2 = max(len(text), 1), max(len(text2), 1)
            if text2 and conf2 ** (1.0 / n2) > conf ** (1.0 / n1):
                out[i] = (quad, text2, conf2)
        return out

    def reread_isbn(self, image: np.ndarray, results) -> Optional[str]:
        """Digit-biased full-resolution re-read of ISBN-suspect boxes (text
        naming ISBN or a long digit-like run), most digits first; the first
        checksum-valid ISBN wins (``decode.isbn``)."""
        # imported here: decode.isbn needs extract.heuristics, whose package
        # imports this module
        from bbocr_tpu_torch.decode.isbn import decode_isbn, is_isbn_suspect

        suspects = [(sum(c.isdigit() for c in text), quad) for quad, text, _ in results if is_isbn_suspect(text)]
        for _, quad in sorted(suspects, key=lambda e: -e[0])[:3]:
            logits, frames = self.isbn_logits(image, quad)
            isbn = decode_isbn(logits[:frames], self.charset)
            if isbn:
                return isbn
        return None


def _to_unit_range(crops: torch.Tensor) -> torch.Tensor:
    """[0, 255] -> [-1, 1] as the JAX engine's compiled program computes
    ``crops / 127.5 - 1``: one fused multiply-add by the float32 reciprocal
    (emulated in float64)."""
    return (crops.double() * _INV_127_5 - 1.0).float()


def _percentile(ordered: torch.Tensor, pct: float) -> torch.Tensor:
    """``jnp.percentile(x, pct)`` (linear) over the sorted rows of
    ``ordered`` (N, n), float32, as XLA computes it on the CPU inside the
    JAX engine's compiled ``_contrast_stretch``: the index is
    ``(pct / 100) * (n - 1)`` in float32, and the interpolation
    ``low * (1 - w) + high * w`` is one fused multiply-add (emulated in
    float64)."""
    n = ordered.shape[1]
    idx = np.float32(pct / 100.0) * np.float32(n - 1)
    w_high = idx - np.floor(idx)
    w_low = np.float32(1.0) - w_high
    low, high = ordered[:, int(np.floor(idx))], ordered[:, min(int(np.ceil(idx)), n - 1)]
    return (low.double() * float(w_low) + (high * float(w_high)).double()).float()


def _contrast_stretch(crops: torch.Tensor, lo_pct: float = 10.0, hi_pct: float = 90.0) -> torch.Tensor:
    """Percentile contrast stretch per crop (N, H, W) -> full [0,255] range,
    with the JAX engine's percentiles bit for bit (``_percentile``)."""
    ordered = torch.sort(crops.reshape(crops.shape[0], -1), dim=1).values
    lo, hi = (_percentile(ordered, p)[:, None, None] for p in (lo_pct, hi_pct))
    span = torch.clamp(hi - lo, min=1.0)
    scale = torch.full_like(span, 255.0) / span  # one rounding: `255.0 / span` is 255 * (1 / span)
    return torch.clamp((crops - lo) * scale, 0.0, 255.0)


_LETTERBOX_POOL = None
_LETTERBOX_POOL_LOCK = threading.Lock()


def _letterbox_pool() -> ThreadPoolExecutor:
    """The process-wide pool of 8 host threads, made on first use, as the
    JAX engine's ``_letterbox_pool``. Its tasks (a letterbox fill, one
    crop's warp) submit nothing to it, so a stage thread of
    ``readtext_stream`` that waits on its tasks while another stage
    thread's tasks run cannot deadlock it. The C++ warp is a ``ctypes``
    call and numpy's integer arithmetic and fancy indexing in
    ``_host_resize`` run without the GIL for most of their time."""
    global _LETTERBOX_POOL
    with _LETTERBOX_POOL_LOCK:
        if _LETTERBOX_POOL is None:
            _LETTERBOX_POOL = ThreadPoolExecutor(max_workers=8)
        return _LETTERBOX_POOL


def _serial_map(fn, tasks: list) -> None:
    """``fn`` over ``tasks`` in a loop on the calling thread."""
    for task in tasks:
        fn(task)


def _host_map(fn, tasks: list) -> None:
    """``fn`` over ``tasks`` on the host pool when there is more than one,
    inline for one, as the JAX engine maps its host stages. Each task
    writes only its own slot, so the results are the serial loop's
    (``_serial_map``)."""
    if len(tasks) > 1:
        list(_letterbox_pool().map(fn, tasks))
    else:
        _serial_map(fn, tasks)


def _rank_device(device, mesh) -> torch.device:
    """This rank's device under ``mesh``: ``cuda`` without an index is the
    rank's card (``LOCAL_RANK``, as torchrun sets it, else the rank modulo
    the cards); its type must be the mesh's."""
    dev = torch.device(device)
    if dev.type != mesh.device_type:
        raise ValueError(f"the engine's device {dev} is not of the mesh's type {mesh.device_type!r}")
    if dev.type == "cuda" and dev.index is None:
        import torch.distributed as dist

        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None else dist.get_rank() % torch.cuda.device_count())
    return dev


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
