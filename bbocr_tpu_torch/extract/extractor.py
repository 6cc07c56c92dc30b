"""The book-metadata extraction pipeline: images -> structured JSON.

Counterpart of ``bbocr_tpu/extract/extractor.py::BookMetadataExtractor`` on
its heuristic branch: each OCR'd photo is preprocessed once on the device,
optionally cropped to its text region (``crop_for_ocr``, the auto-crop of
``preprocess/autocrop.py``), read by the OCR engine, grouped into lines,
and structured by the heuristics into metadata that passes the schema. No
LLM client and no HTTP session exist here.

The OCR route is the JAX extractor's. With no ``engine`` argument the
extractor takes the process-wide shared engine, as the JAX one does: an
``OCREngine`` from ``BB_OCR_CKPT_DIR``, wrapped in
``runtime/batching.BatchingOCR`` unless ``BB_OCR_BATCHING`` is false. The
wrapper has neither the fast path nor the re-reads, so by default camera
photos (long side of 1200 px or more, ``auto_rotate=None``) are read at the
four right-angle rotations (``runtime/orient.py``) and smaller ones with
``readtext``. With an unwrapped engine (passed in, or
``BB_OCR_BATCHING=0``) smaller upright photos take the single-dispatch
fast path (``fast_single=None``), and the chosen reading gets the
low-confidence full-resolution re-read (``reread_low_conf``) and the
digit-biased ISBN re-read (``isbn_reread``). Photos over the OCR size limit
are downscaled with Pillow's BILINEAR resample, reproduced in numpy
(``ops.pil_bilinear_resize_u8``).

Knobs whose modules are not ported yet raise ``NotImplementedError``
naming their ROADMAP.md item: LLM backends and traces. As in the JAX
extractor, an image whose OCR raises prints ``OCR failed: ...`` and adds no
text, a raising low-confidence re-read keeps the first reading, and a
raising ISBN re-read adds no ISBN line (the re-read inside
``read_with_rotations`` has no handler, in JAX either).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from bbocr_tpu_torch.extract.heuristics import heuristic_extract, heuristic_extract_lines
from bbocr_tpu_torch.extract.schema import empty_metadata, validate_schema
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.ops import pil_bilinear_resize_u8
from bbocr_tpu_torch.runtime.orient import read_with_rotations
from bbocr_tpu_torch.utils.env import env_flag

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".gif", ".bmp", ".tiff")
_CKPT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "checkpoints")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: see ROADMAP.md Queue 1")


class BookMetadataExtractor:
    """images -> OCR context -> heuristics -> validated metadata."""

    def __init__(
        self,
        model: str = "gemma3:4b",
        use_preprocessing: bool = True,
        crop_for_ocr: bool = False,
        crop_margin: int = 128,
        warm_model: bool = True,
        edge_crop_percent: float = 0.0,
        max_ocr_chars_per_image: int = 330,
        llm_backend: str = "ollama",
        engine: Optional[Any] = None,
        isbn_reread: bool = True,
        auto_rotate: Optional[bool] = None,
        reread_low_conf: bool = True,
        fast_single: Optional[bool] = None,
        device="cuda",
    ):
        """Same knobs and defaults as the JAX extractor. ``warm_model`` only
        warms an Ollama model, so it does nothing on the heuristic backend.
        ``device`` is where preprocessing, the auto-crop's mask and the
        shared engine run. ``BB_OCR_DEBUG_AUTOCROP`` set true skips the
        auto-crop and returns an all-null stub after OCR, as in JAX."""
        self.llm_backend = (llm_backend or "ollama").lower()
        if self.llm_backend != "heuristic":
            raise _not_ported(f"llm_backend={self.llm_backend!r} (LLM backends)")
        self.model = model
        self.use_preprocessing = use_preprocessing
        self.crop_for_ocr = crop_for_ocr
        self.crop_margin = int(max(0, crop_margin))
        self.edge_crop_percent = float(max(0.0, min(45.0, edge_crop_percent)))
        self.max_ocr_chars_per_image = int(max(1, max_ocr_chars_per_image))
        self.isbn_reread = bool(isbn_reread)
        self.auto_rotate = auto_rotate
        self.reread_low_conf = bool(reread_low_conf)
        self.fast_single = fast_single
        self.device = device
        self._engine = engine
        self.debug_autocrop = env_flag("BB_OCR_DEBUG_AUTOCROP")

    @property
    def engine(self):
        """The OCR engine: the one passed in, else the process-wide shared
        engine of ``device``, built on first use."""
        if self._engine is None:
            self._engine = _shared_engine(self.device)
        return self._engine

    # ------------------------------------------------------------------
    # Per-image processing
    # ------------------------------------------------------------------

    def _process_image(self, rgb: np.ndarray) -> Dict[str, Any]:
        """Preprocessing and crops of one image; returns all artifacts."""
        out: Dict[str, Any] = {"original": rgb, "steps": ["original"]}
        current: np.ndarray = rgb
        if self.use_preprocessing:
            from bbocr_tpu_torch.preprocess import preprocess_for_book_cover

            pre, steps = preprocess_for_book_cover(rgb, device=self.device)
            current = pre.cpu().numpy()
            out["steps"] = steps
            out["preprocessed"] = current
        if self.edge_crop_percent > 0.0:
            from bbocr_tpu_torch.preprocess import central_edge_crop

            rect = central_edge_crop(current.shape[:2], self.edge_crop_percent)
            if rect is not None:
                x0, y0, x1, y1 = rect
                current = current[y0:y1, x0:x1]
                out["edge_cropped"] = current
        if self.crop_for_ocr and not self.debug_autocrop:
            from bbocr_tpu_torch.preprocess import auto_crop_text_region

            rect = auto_crop_text_region(current, self.crop_margin, device=self.device)
            if rect is not None:
                x0, y0, x1, y1 = rect
                current = current[y0:y1, x0:x1]
                out["auto_cropped"] = current
        out["final"] = current
        return out

    def _ocr_text(self, image: np.ndarray, image_index: Optional[int]):
        """OCR with the per-index downscale policy -> (joined text, lines,
        line infos (text, mean confidence, relative height, image index))."""
        max_dim = 1600 if (image_index is None or image_index == 0) else 2400
        h, w = image.shape[:2]
        orig_long_side = max(h, w)
        if orig_long_side > max_dim:
            scale = max_dim / orig_long_side
            u8 = np.clip(image, 0, 255).astype(np.uint8)
            image = pil_bilinear_resize_u8(u8, int(w * scale), int(h * scale)).astype(np.float32)

        eng = self.engine
        reread_ths = 0.5 if (self.reread_low_conf and hasattr(eng, "reread_low_conf")) else 0.0
        # camera photos arrive sideways
        rotate = self.auto_rotate if self.auto_rotate is not None else orig_long_side >= 1200
        use_fast = (
            self.fast_single if self.fast_single is not None else (not rotate and orig_long_side < 1200)
        ) and hasattr(eng, "readtext_fast")
        if rotate:
            res, _ = read_with_rotations(eng, image, reread_conf_ths=reread_ths)
        else:
            res = eng.readtext_fast(image) if use_fast else eng.readtext(image)
            if reread_ths > 0 and res:
                try:
                    res = eng.reread_low_conf(image, res, conf_ths=reread_ths)
                except Exception:  # keep the first reading, as the JAX extractor does
                    pass
        from bbocr_tpu_torch.decode import group_lines

        infos = []
        if res:
            grouped = group_lines([r[0] for r in res])
            heights = []
            for line in grouped:
                hs = [float(np.linalg.norm(np.asarray(res[i][0])[3] - np.asarray(res[i][0])[0])) for i in line]
                heights.append(sum(hs) / len(hs))
            h_max = max(heights) if heights else 1.0
            for line, lh in zip(grouped, heights):
                txt = " ".join(res[i][1] for i in line)
                conf = sum(float(res[i][2]) for i in line) / len(line)
                infos.append((txt, conf, lh / max(h_max, 1e-6), image_index or 0))
        # Context lines: confident results only.
        strong = [r for r in res if r[2] >= 0.3 and len(r[1].strip()) >= 2] or res
        lines = []
        if strong:
            grouped = group_lines([r[0] for r in strong])
            lines = [" ".join(strong[i][1] for i in line) for line in grouped]
        # A checksum-valid ISBN from the digit-biased re-read is its own
        # line. As in the JAX extractor, the re-read takes the unrotated
        # image with the chosen reading's quads.
        if self.isbn_reread and res and hasattr(eng, "reread_isbn"):
            try:
                isbn = eng.reread_isbn(image, res)
            except Exception:  # no ISBN line, as in the JAX extractor
                isbn = None
            if isbn:
                lines = [ln for ln in lines if "isbn" not in ln.lower()]
                lines.append(f"ISBN {isbn}")
                infos.append((f"ISBN {isbn}", 1.0, 0.2))
        return " ".join(lines), lines, infos, len(res)

    # ------------------------------------------------------------------
    # Main entry point
    # ------------------------------------------------------------------

    def extract_metadata_from_images(
        self,
        images: Sequence,
        ocr_image_indices: Optional[List[int]] = None,
        *,
        capture_trace: bool = False,
    ) -> Dict[str, Any]:
        """Paths or arrays -> metadata dict. The default OCR plan skips the
        cover: [1, 2] for three or more images, [1] for two, [] for one."""
        if not images:
            raise ValueError("No image paths provided")
        if capture_trace:
            raise _not_ported("capture_trace=True (traces)")
        if ocr_image_indices is None:
            ocr_image_indices = [1, 2] if len(images) > 2 else [1] if len(images) > 1 else []
        rgbs = [load_rgb(p) for p in images]
        ocr_texts: List[str] = []
        ocr_lines: List[str] = []
        ocr_line_infos: List[Any] = []
        n_boxes = 0
        for idx in ocr_image_indices:
            if not (0 <= idx < len(images)):
                continue
            proc = self._process_image(rgbs[idx])
            try:
                text, lines, infos, n = self._ocr_text(proc["final"], idx)
            except Exception as e:  # the photo adds no text, as in the JAX extractor
                print(f"OCR failed: {e}")
                text, lines, infos, n = "", [], [], 0
            ocr_lines.extend(lines)
            ocr_line_infos.extend(infos)
            n_boxes += n
            if text.strip() and len(text) <= self.max_ocr_chars_per_image:
                ocr_texts.append(text)

        if self.debug_autocrop:  # a stub without structuring, as in JAX
            stub = empty_metadata()
            stub["_processing_info"] = {
                "ocr_engine": "torch",
                "preprocessing_used": self.use_preprocessing,
                "ocr_images_processed": len(ocr_texts),
                "total_images": len(images),
                "debug_autocrop": True,
                "model_skipped": True,
            }
            return stub
        if ocr_line_infos:
            meta = heuristic_extract_lines(ocr_line_infos)
        else:
            meta = heuristic_extract("\n".join(ocr_lines or ocr_texts))
        meta["_processing_info"] = {
            "model_used": self.model,
            "llm_backend": self.llm_backend,
            "ocr_engine": "torch",
            "preprocessing_used": self.use_preprocessing,
            "ocr_images_processed": len(ocr_texts),
            "total_images": len(images),
            "ocr_boxes": n_boxes,
            "structurer": "heuristic",
        }
        if self._engine is not None:
            meta["_processing_info"]["engine_timings"] = self._engine.timings()
        validate_schema(meta)
        return meta

    def process_book_directory(self, book_dir: str, ocr_image_indices: Optional[List[int]] = None) -> Dict[str, Any]:
        """All images in a directory, sorted, with the default OCR plan."""
        paths = [
            os.path.join(book_dir, f)
            for f in sorted(os.listdir(book_dir))
            if f.lower().endswith(_IMAGE_EXTS)
        ]
        if not paths:
            raise FileNotFoundError(f"No image files found in {book_dir}")
        return self.extract_metadata_from_images(paths, ocr_image_indices)



# One engine per device and process, shared by every extractor (the
# parameters are immutable), as the JAX package shares one per process.
_ENGINE_CACHE: Dict[str, Any] = {}


def _shared_engine(device="cuda"):
    """The process-wide engine of ``device``: ``OCREngine.from_checkpoint``
    on ``craft.npz`` and ``crnn.npz`` of ``BB_OCR_CKPT_DIR`` (default the
    repository's ``checkpoints/``), wrapped in ``BatchingOCR`` unless
    ``BB_OCR_BATCHING`` is false. Raises if a checkpoint is missing (the
    JAX package then initialises untrained weights, which the port does not
    port)."""
    key = str(torch.device(device))
    if key not in _ENGINE_CACHE:
        from bbocr_tpu_torch.runtime import OCREngine

        ckpt_dir = os.getenv("BB_OCR_CKPT_DIR", _CKPT_DIR)
        paths = [os.path.join(ckpt_dir, name) for name in ("craft.npz", "crnn.npz")]
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(f"OCR checkpoints not found: {missing} (set BB_OCR_CKPT_DIR)")
        engine = OCREngine.from_checkpoint(*paths, device=device)
        if env_flag("BB_OCR_BATCHING", default=True):
            # coalesce concurrent requests into one device batch
            from bbocr_tpu_torch.runtime.batching import BatchingOCR

            engine = BatchingOCR(engine)
        _ENGINE_CACHE[key] = engine
    return _ENGINE_CACHE[key]
