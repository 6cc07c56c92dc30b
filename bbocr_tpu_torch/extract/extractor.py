"""The book-metadata extraction pipeline: images -> structured JSON.

Counterpart of ``bbocr_tpu/extract/extractor.py::BookMetadataExtractor`` on
its heuristic branch: each OCR'd photo is preprocessed once on the device,
read by the OCR engine, grouped into lines, and structured by the
heuristics into metadata that passes the schema. No LLM client and no HTTP
session exist here.

Knobs whose modules are not ported yet raise ``NotImplementedError``
naming their ROADMAP.md item: LLM backends, auto-crop, re-reads, the
single-dispatch fast path, rotations, and traces. ``auto_rotate`` and
``fast_single`` left at ``None`` resolve per image as in the JAX package,
and raise when they resolve to True. Errors propagate: unlike the JAX
extractor, a failed OCR call is not turned into empty text.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from bbocr_tpu_torch.extract.heuristics import heuristic_extract, heuristic_extract_lines
from bbocr_tpu_torch.extract.schema import validate_schema
from bbocr_tpu_torch.io import load_rgb

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
        ``device`` is where preprocessing and the default engine run."""
        self.llm_backend = (llm_backend or "ollama").lower()
        if self.llm_backend != "heuristic":
            raise _not_ported(f"llm_backend={self.llm_backend!r} (LLM backends)")
        if crop_for_ocr:
            raise _not_ported("crop_for_ocr=True (auto-crop)")
        if isbn_reread or reread_low_conf:
            raise _not_ported("isbn_reread / reread_low_conf (re-reads)")
        if auto_rotate:
            raise _not_ported("auto_rotate=True (rotations, runtime/orient.py)")
        if fast_single:
            raise _not_ported("fast_single=True (single-dispatch fast path)")
        self.model = model
        self.use_preprocessing = use_preprocessing
        self.edge_crop_percent = float(max(0.0, min(45.0, edge_crop_percent)))
        self.max_ocr_chars_per_image = int(max(1, max_ocr_chars_per_image))
        self.auto_rotate = auto_rotate
        self.fast_single = fast_single
        self.device = device
        self._engine = engine

    @property
    def engine(self):
        """The OCR engine, built on first use from ``BB_OCR_CKPT_DIR`` (default
        the repository's ``checkpoints/``)."""
        if self._engine is None:
            from bbocr_tpu_torch.runtime import OCREngine

            ckpt_dir = os.getenv("BB_OCR_CKPT_DIR", _CKPT_DIR)
            self._engine = OCREngine.from_checkpoint(
                os.path.join(ckpt_dir, "craft.npz"), os.path.join(ckpt_dir, "crnn.npz"),
                device=self.device,
            )
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
        out["final"] = current
        return out

    def _ocr_text(self, image: np.ndarray, image_index: Optional[int]):
        """OCR with the per-index downscale policy -> (joined text, lines,
        line infos (text, mean confidence, relative height, image index))."""
        max_dim = 1600 if (image_index is None or image_index == 0) else 2400
        h, w = image.shape[:2]
        orig_long_side = max(h, w)
        rotate = self.auto_rotate if self.auto_rotate is not None else orig_long_side >= 1200
        if rotate:
            raise _not_ported("auto_rotate resolving to True for a camera-shaped photo (rotations)")
        use_fast = self.fast_single if self.fast_single is not None else orig_long_side < 1200
        if use_fast:
            raise _not_ported("fast_single resolving to True for an upright small photo (fast path)")
        if orig_long_side > max_dim:
            image = _pil_bilinear_resize(image, max_dim / orig_long_side)

        res = self.engine.readtext(image)
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
            text, lines, infos, n = self._ocr_text(proc["final"], idx)
            ocr_lines.extend(lines)
            ocr_line_infos.extend(infos)
            n_boxes += n
            if text.strip() and len(text) <= self.max_ocr_chars_per_image:
                ocr_texts.append(text)

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


def _pil_bilinear_resize(image: np.ndarray, scale: float) -> np.ndarray:
    """PIL BILINEAR downscale, as the JAX extractor does for large images."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("downscaling an image over the OCR size limit needs Pillow") from e
    h, w = image.shape[:2]
    pil = Image.fromarray(np.clip(image, 0, 255).astype(np.uint8))
    return np.asarray(pil.resize((int(w * scale), int(h * scale)), Image.BILINEAR), np.float32)
