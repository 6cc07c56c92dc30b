"""The book-metadata extraction pipeline: images -> structured JSON.

Counterpart of ``bbocr_tpu/extract/extractor.py::BookMetadataExtractor``,
with the same knobs, defaults, backends and trace. Each OCR'd photo is
preprocessed once on the device, optionally edge-cropped and cropped to its
text region (``crop_for_ocr``, the auto-crop of ``preprocess/autocrop.py``),
and read by the OCR engine; the text goes into the prompt of a vision LLM
(``ollama``, the default, ``openai`` or ``gemini``, through
``llm/client.py``) together with JPEGs of every photo, or is structured by
the heuristics (``llm_backend="heuristic"``). The reply is repaired
(``jsonrepair.py``), checked against the schema, and falls back to the
all-null metadata when it does not parse. ``llm_backend="tpu"`` is the
PageReader on ``device`` (``llm/native_vlm.py``): it reads the first
photo's JPEG of the model inputs and ignores the prompt, and needs no HTTP
session.

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
digit-biased ISBN re-read (``isbn_reread``). ``ocr_engine="tesseract"`` is
the CPU escape hatch through ``pytesseract`` (and Pillow), imported when
used. As in the JAX extractor, an image whose OCR raises prints
``OCR failed: ...`` and adds no text, a raising low-confidence re-read
keeps the first reading, and a raising ISBN re-read adds no ISBN line (the
re-read inside ``read_with_rotations`` has no handler, in JAX either).

Where the JAX extractor calls Pillow, the port calls its own numpy and C++
equivalents, equal to Pillow's output: photos over the OCR size limit are
downscaled with Pillow's BILINEAR (``ops.pil_resample_u8``), the model's
inputs are ``Image.thumbnail`` (``io.pil_thumbnail_u8``) then Pillow's JPEG
(``io.encode_jpeg``), and the trace's previews are 800 px thumbnails as PNG
(``io.encode_png``). The HTTP session is made on first use, so that
``requests`` is needed only when no session is passed.
"""

from __future__ import annotations

import base64
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from bbocr_tpu_torch.extract.heuristics import heuristic_extract, heuristic_extract_lines
from bbocr_tpu_torch.extract.jsonrepair import repair_and_parse
from bbocr_tpu_torch.extract.prompt import PROMPT_TEMPLATE, build_prompt
from bbocr_tpu_torch.extract.schema import empty_metadata, validate_schema
from bbocr_tpu_torch.io import as_u8_image, encode_jpeg, encode_png, load_rgb, pil_thumbnail_u8
from bbocr_tpu_torch.ops import pil_resample_u8
from bbocr_tpu_torch.runtime.orient import read_with_rotations
from bbocr_tpu_torch.utils.env import env_flag

TraceSink = Callable[[Dict[str, Any]], None]

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".gif", ".bmp", ".tiff")
_CKPT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "checkpoints")


def _new_http_session() -> Any:
    try:
        import requests
    except ImportError as e:
        raise ImportError(
            "the extractor's LLM backends need the requests package for their HTTP session; "
            "set extractor.session (or pass session=...) to use another one"
        ) from e
    session = requests.Session()
    session.trust_env = False
    return session


class BookMetadataExtractor:
    """images -> OCR context -> (VLM | heuristics) -> validated metadata."""

    def __init__(
        self,
        model: str = "gemma3:4b",
        prompt_template: Optional[str] = None,
        ocr_engine: str = "tpu",
        use_preprocessing: bool = True,
        crop_for_ocr: bool = False,
        crop_margin: int = 128,
        warm_model: bool = True,
        edge_crop_percent: float = 0.0,
        ollama_timeout_seconds: float = 300.0,
        max_ocr_chars_per_image: int = 330,
        llm_backend: str = "ollama",
        engine: Optional[Any] = None,
        ollama_base_url: str = "http://127.0.0.1:11434",
        isbn_reread: bool = True,
        auto_rotate: Optional[bool] = None,
        reread_low_conf: bool = True,
        fast_single: Optional[bool] = None,
        device="cuda",
        session: Optional[Any] = None,
    ):
        """Same knobs and defaults as the JAX extractor. ``ocr_engine``:
        ``"tpu"`` is the port's CRAFT + CRNN engine, ``"tesseract"`` the
        escape hatch. ``device`` is where preprocessing, the auto-crop's
        mask and the shared engine run. ``session``: the HTTP session of the
        LLM backends (anything with ``post(url, json=, timeout=, [headers=])``
        returning a response with ``status_code``, ``text`` and ``json()``);
        without one, a ``requests.Session`` is made on first use.
        ``warm_model`` sends Ollama a ping at construction, best effort.
        ``BB_OCR_DEBUG_AUTOCROP`` set true skips the auto-crop and returns an
        all-null stub after OCR, as in JAX."""
        self.model = model
        self.ocr_engine = (ocr_engine or "tpu").lower()
        self.use_preprocessing = use_preprocessing
        self.crop_for_ocr = crop_for_ocr
        self.crop_margin = int(max(0, crop_margin))
        self.edge_crop_percent = float(max(0.0, min(45.0, edge_crop_percent)))
        self.llm_timeout_seconds = float(max(5.0, ollama_timeout_seconds))
        self.llm_backend = (llm_backend or "ollama").lower()
        self.max_ocr_chars_per_image = int(max(1, max_ocr_chars_per_image))
        self.isbn_reread = bool(isbn_reread)
        self.auto_rotate = auto_rotate
        self.reread_low_conf = bool(reread_low_conf)
        self.fast_single = fast_single
        self.prompt_template = prompt_template if prompt_template is not None else PROMPT_TEMPLATE
        self.ollama_base_url = ollama_base_url
        self.device = device
        self._trace_sink: Optional[TraceSink] = None
        self._engine = engine
        self._session = session
        self._last_llm_usage = None
        self.debug_autocrop = env_flag("BB_OCR_DEBUG_AUTOCROP")

        if warm_model and self.llm_backend == "ollama":
            try:
                self._warm_ollama_model()
            except Exception as e:  # warm-up is best-effort
                print(f"Warning: model warm-up skipped due to error: {e}")

    # ------------------------------------------------------------------
    # Infrastructure
    # ------------------------------------------------------------------

    @property
    def engine(self):
        """The OCR engine: the one passed in, else (for ``ocr_engine="tpu"``)
        the process-wide shared engine of ``device``, built on first use."""
        if self._engine is None and self.ocr_engine == "tpu":
            self._engine = _shared_engine(self.device)
        return self._engine

    @property
    def session(self):
        """The LLM backends' HTTP session, made on first use."""
        if self._session is None:
            self._session = _new_http_session()
        return self._session

    @session.setter
    def session(self, value) -> None:
        self._session = value

    def set_trace_sink(self, sink: Optional[TraceSink]) -> None:
        self._trace_sink = sink

    def _emit_trace(self, trace: Dict[str, Any]) -> None:
        try:
            if self._trace_sink is not None:
                self._trace_sink(dict(trace))  # shallow copy: no mutation races
        except Exception:
            pass

    def _warm_ollama_model(self) -> None:
        payload = {"model": self.model, "prompt": "ping", "stream": False}
        resp = self.session.post(f"{self.ollama_base_url}/api/generate", json=payload, timeout=(5, 30))
        if resp.status_code != 200:
            raise RuntimeError(f"Warm-up status {resp.status_code}")
        print("Model warm-up request sent")

    # ------------------------------------------------------------------
    # Image helpers (host work, as in the JAX extractor)
    # ------------------------------------------------------------------

    @staticmethod
    def _to_data_url(arr: Optional[np.ndarray], max_dim: int = 800) -> Optional[str]:
        """PNG preview data URL of the thumbnail, or None on any error."""
        if arr is None:
            return None
        try:
            png = encode_png(pil_thumbnail_u8(as_u8_image(arr), max_dim))
            return "data:image/png;base64," + base64.b64encode(png).decode()
        except Exception:
            return None

    @staticmethod
    def _encode_jpeg_b64(arr: np.ndarray, max_dim: int, quality: int) -> str:
        """Model-input JPEG base64: the thumbnail, as RGB, quality 50..95."""
        thumb = pil_thumbnail_u8(as_u8_image(arr), max_dim)
        return base64.b64encode(encode_jpeg(thumb, int(max(50, min(95, quality))))).decode()

    # ------------------------------------------------------------------
    # Per-image processing (preprocess -> crops), computed once per image
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
        line infos (text, mean confidence, relative height, image index),
        number of boxes read)."""
        max_dim = 1600 if (image_index is None or image_index == 0) else 2400
        h, w = image.shape[:2]
        orig_long_side = max(h, w)
        if orig_long_side > max_dim:
            scale = max_dim / orig_long_side
            image = pil_resample_u8(as_u8_image(image), int(w * scale), int(h * scale)).astype(np.float32)

        if self.ocr_engine == "tesseract":
            try:
                import pytesseract
                from PIL import Image

                text = pytesseract.image_to_string(Image.fromarray(as_u8_image(image)))
                return text, [ln for ln in text.split("\n") if ln.strip()], [], 0
            except ImportError as e:
                raise RuntimeError("tesseract escape hatch unavailable (pytesseract not installed)") from e
        if self.ocr_engine != "tpu":
            raise ValueError(f"Unsupported OCR engine: {self.ocr_engine}")

        eng = self.engine
        if not hasattr(eng, "readtext"):  # an engine that only joins its text
            text = eng.read_joined(image)
            return text, ([text] if text else []), [], 0
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

    def extract_text_with_ocr(
        self,
        image,
        trace_image: Optional[Dict[str, Any]] = None,
        trace_global: Optional[Dict[str, Any]] = None,
        *,
        step_log: Optional[List[Dict[str, Any]]] = None,
        image_index: Optional[int] = None,
        processed: Optional[Dict[str, Any]] = None,
        lines_out: Optional[List[str]] = None,
        line_infos_out: Optional[List[Any]] = None,
        boxes_out: Optional[List[int]] = None,
    ) -> str:
        """Single-image OCR with trace events: ``preprocess``,
        ``edge_crop``, ``auto_crop`` (each with its preview) and ``ocr``.
        ``boxes_out`` receives the number of boxes read."""
        rgb = load_rgb(image)
        if trace_image is not None and "original_b64" not in trace_image:
            trace_image["original_b64"] = self._to_data_url(rgb)
        proc = processed if processed is not None else self._process_image(rgb)

        if trace_image is not None:
            for key, step, info in (
                ("preprocessed", "preprocess", True),
                ("edge_cropped", "edge_crop", False),
                ("auto_cropped", "auto_crop", False),
            ):
                if key not in proc:
                    continue
                if info:
                    trace_image["preprocessing_steps"] = proc["steps"]
                trace_image[f"{key}_b64"] = self._to_data_url(proc[key])
                if step_log is not None:
                    event = {"step": step, "image_index": None, "images": {f"{key}_b64": trace_image.get(f"{key}_b64")}}
                    if info:
                        event["info"] = {"steps": proc["steps"]}
                    step_log.append(event)
                if trace_global is not None:
                    self._emit_trace(trace_global)

        try:
            text, lines, infos, n_boxes = self._ocr_text(proc["final"], image_index)
        except Exception as e:  # the photo adds no text, as in the JAX extractor
            print(f"OCR failed: {e}")
            text, lines, infos, n_boxes = "", [], [], 0
        if lines_out is not None:
            lines_out.extend(lines)
        if line_infos_out is not None:
            line_infos_out.extend(infos)
        if boxes_out is not None:
            boxes_out.append(n_boxes)

        if trace_image is not None:
            trace_image["ocr_text"] = text
            if step_log is not None:
                step_log.append({"step": "ocr", "image_index": None, "info": {"chars": len(text)}})
            if trace_global is not None:
                self._emit_trace(trace_global)
        return text

    # ------------------------------------------------------------------
    # Main entry point
    # ------------------------------------------------------------------

    def extract_metadata_from_images(
        self,
        images: Sequence,
        ocr_image_indices: Optional[List[int]] = None,
        *,
        capture_trace: bool = False,
        trace_sink: Optional[TraceSink] = None,
    ) -> Dict[str, Any]:
        """Paths or arrays -> metadata dict. The default OCR plan skips the
        cover: [1, 2] for three or more images, [1] for two, [] for one.
        ``capture_trace`` adds the live trace under ``_trace``; ``trace_sink``
        (or ``set_trace_sink``) receives a shallow copy of it at each step."""
        if not images:
            raise ValueError("No image paths provided")
        if ocr_image_indices is None:
            ocr_image_indices = [1, 2] if len(images) > 2 else [1] if len(images) > 1 else []
        old_sink = self._trace_sink
        if trace_sink is not None:
            self._trace_sink = trace_sink
        try:
            return self._extract(list(images), list(ocr_image_indices), capture_trace)
        finally:
            self._trace_sink = old_sink

    def _extract(self, images: List, ocr_indices: List[int], capture_trace: bool) -> Dict[str, Any]:
        trace: Dict[str, Any] = {"images": [], "steps": []} if capture_trace else {}
        rgbs = [load_rgb(p) for p in images]
        processed: Dict[int, Dict[str, Any]] = {}

        if capture_trace:
            for rgb in rgbs:
                trace["images"].append({"original_b64": self._to_data_url(rgb)})
            trace["steps"].append({"step": "seed_images", "info": {"count": len(images)}})
            self._emit_trace(trace)

        # OCR phase: each targeted image processed once.
        ocr_texts: List[str] = []
        ocr_lines: List[str] = []
        ocr_line_infos: List[Any] = []
        boxes: List[int] = []
        for idx in ocr_indices:
            if not (0 <= idx < len(images)):
                continue
            if capture_trace:
                trace["steps"].append({"step": "start_ocr", "image_index": idx})
                self._emit_trace(trace)
            processed[idx] = self._process_image(rgbs[idx])
            text = self.extract_text_with_ocr(
                rgbs[idx],
                trace_image=trace["images"][idx] if capture_trace else None,
                trace_global=trace if capture_trace else None,
                step_log=trace.get("steps") if capture_trace else None,
                image_index=idx,
                processed=processed[idx],
                lines_out=ocr_lines,
                line_infos_out=ocr_line_infos,
                boxes_out=boxes,
            )
            if text.strip():
                if len(text) > self.max_ocr_chars_per_image:
                    # long OCR text is noise for the VLM context: drop it
                    if capture_trace:
                        trace["steps"].append(
                            {
                                "step": "ocr_skip_long",
                                "image_index": idx,
                                "info": {"chars": len(text), "limit": self.max_ocr_chars_per_image},
                            }
                        )
                        img_tr = trace["images"][idx]
                        img_tr["ocr_skipped_long"] = True
                        img_tr["ocr_chars"] = len(text)
                        self._emit_trace(trace)
                else:
                    ocr_texts.append(text)

        # Preview artifacts for non-OCR, non-cover images (UI thumbnails).
        if capture_trace:
            for idx in range(1, len(images)):
                if idx in processed or idx in ocr_indices:
                    continue
                processed[idx] = self._process_image(rgbs[idx])
                tr_img = trace["images"][idx]
                proc = processed[idx]
                if "preprocessed" in proc:
                    tr_img["preprocessing_steps"] = proc["steps"]
                    tr_img["preprocessed_b64"] = self._to_data_url(proc["preprocessed"])
                    trace["steps"].append({"step": "preprocess_preview", "image_index": idx, "info": {"steps": proc["steps"]}})
                if "edge_cropped" in proc:
                    tr_img["edge_cropped_b64"] = self._to_data_url(proc["edge_cropped"])
                    trace["steps"].append({"step": "edge_crop_preview", "image_index": idx})
                if "auto_cropped" in proc:
                    tr_img["auto_cropped_b64"] = self._to_data_url(proc["auto_cropped"])
                    trace["steps"].append({"step": "auto_crop_preview", "image_index": idx})
                self._emit_trace(trace)

        if self.debug_autocrop:  # a stub without a model request, as in JAX
            stub = empty_metadata()
            stub["_processing_info"] = {
                "ocr_engine": self.ocr_engine,
                "preprocessing_used": self.use_preprocessing,
                "ocr_images_processed": len(ocr_texts),
                "total_images": len(images),
                "debug_autocrop": True,
                "model_skipped": True,
            }
            if capture_trace:
                stub["_trace"] = dict(trace)
            return stub

        prompt = build_prompt(ocr_texts, self.prompt_template)
        if capture_trace:
            trace["enhanced_prompt"] = prompt
            trace["steps"].append({"step": "build_prompt", "info": {"chars": len(prompt)}})
            self._emit_trace(trace)

        # Heuristic-only backend: structure straight from OCR text, no VLM.
        if self.llm_backend == "heuristic":
            if ocr_line_infos:
                meta = heuristic_extract_lines(ocr_line_infos)
            else:
                meta = heuristic_extract("\n".join(ocr_lines or ocr_texts))
            # No OCR text makes the heuristics break the schema (each field
            # is a string, a list of strings or the price's float), so this
            # check never fires; it stays as the contract's guard.
            validate_schema(meta)
            meta["_processing_info"] = self._processing_info(ocr_texts, images)
            meta["_processing_info"]["structurer"] = "heuristic"
            meta["_processing_info"]["ocr_boxes"] = sum(boxes)
            if capture_trace:
                meta["_trace"] = trace
                self._emit_trace(trace)
            return meta

        # Model inputs: the processed artifacts where there are some.
        images_b64: List[str] = []
        for idx, rgb in enumerate(rgbs):
            proc = processed.get(idx)
            arr = proc["final"] if proc is not None else rgb
            max_dim = 2000 if idx == 0 else 3200
            quality = 88 if idx == 0 else 95
            images_b64.append(self._encode_jpeg_b64(arr, max_dim, quality))
        if capture_trace:
            trace["steps"].append({"step": "encode_images", "info": {"count": len(images_b64)}})
            self._emit_trace(trace)
            trace["steps"].append(
                {"step": "request_sent", "info": {"model": self.model, "backend": self.llm_backend}}
            )
            self._emit_trace(trace)
        response_text = self._call_llm(prompt, images_b64)
        if capture_trace:
            trace["ollama_raw"] = response_text
            trace["steps"].append({"step": "vlm_raw", "info": {"chars": len(response_text)}})
            self._emit_trace(trace)

        try:
            metadata = repair_and_parse(response_text)
            validate_schema(metadata)
            metadata["_processing_info"] = self._processing_info(ocr_texts, images)
            if capture_trace:
                metadata["_trace"] = trace
                self._emit_trace(trace)
            return metadata
        except json.JSONDecodeError as e:
            fallback = empty_metadata()
            fallback["_processing_info"] = self._processing_info(ocr_texts, images)
            fallback["_processing_info"]["fallback_used"] = True
            fallback["_processing_info"]["ollama_error"] = str(e)
            if capture_trace:
                fallback["_trace"] = trace
                self._emit_trace(trace)
            return fallback
        except Exception as e:
            # a schema violation is a hard error
            if capture_trace:
                self._emit_trace(trace)
            raise Exception(f"JSON validation failed: {e}")

    def _call_llm(self, prompt: str, images_b64: List[str]) -> str:
        from bbocr_tpu_torch.llm import OllamaClient, create_llm_client
        from bbocr_tpu_torch.llm.client import NATIVE_BACKENDS

        self._last_llm_usage = None
        if self.llm_backend == "ollama":
            client = OllamaClient(self.session, self.ollama_base_url)
            last_err: Optional[Exception] = None
            for attempt in range(3):  # retry with back-off
                try:
                    return client.generate(self.model, prompt, images_b64, self.llm_timeout_seconds)
                except Exception as e:
                    last_err = e
                    time.sleep(1.0 * (attempt + 1))
            raise Exception(f"Error from Ollama API: {last_err}")
        if self.llm_backend in NATIVE_BACKENDS:
            client = create_llm_client(self.llm_backend, device=self.device)
        else:
            client = create_llm_client(self.llm_backend, session=self.session)
        out = client.generate(self.model, prompt, images_b64, self.llm_timeout_seconds)
        # per-request cost accounting for metered cloud backends
        self._last_llm_usage = getattr(client, "last_usage", None)
        return out

    def _processing_info(self, ocr_texts: List[str], images: Sequence) -> Dict[str, Any]:
        info = {
            "model_used": self.model,
            "llm_backend": self.llm_backend,
            "ocr_engine": self.ocr_engine,
            "preprocessing_used": self.use_preprocessing,
            "ocr_images_processed": len(ocr_texts),
            "total_images": len(images),
        }
        if self._engine is not None and hasattr(self._engine, "timings"):
            try:
                info["engine_timings"] = self._engine.timings()
            except Exception:
                pass
        if self._last_llm_usage:
            info["llm_usage"] = self._last_llm_usage
        return info

    # ------------------------------------------------------------------
    # Directory driver
    # ------------------------------------------------------------------

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
    ``BB_OCR_BATCHING`` is false. When either checkpoint is missing it
    falls back to ``OCREngine.create()``, untrained weights, as the JAX
    package does."""
    key = str(torch.device(device))
    if key not in _ENGINE_CACHE:
        from bbocr_tpu_torch.runtime import OCREngine

        ckpt_dir = os.getenv("BB_OCR_CKPT_DIR", _CKPT_DIR)
        paths = [os.path.join(ckpt_dir, name) for name in ("craft.npz", "crnn.npz")]
        if all(os.path.exists(p) for p in paths):
            engine = OCREngine.from_checkpoint(*paths, device=device)
        else:
            engine = OCREngine.create(device=device)
        if env_flag("BB_OCR_BATCHING", default=True):
            # coalesce concurrent requests into one device batch
            from bbocr_tpu_torch.runtime.batching import BatchingOCR

            engine = BatchingOCR(engine)
        _ENGINE_CACHE[key] = engine
    return _ENGINE_CACHE[key]
