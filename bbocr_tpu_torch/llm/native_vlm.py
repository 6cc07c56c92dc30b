"""On-card VLM backend: the PageReader instead of an external model server.

Counterpart of ``bbocr_tpu/llm/native_vlm.py``. The client satisfies the
``LLMClient.generate`` contract with the PageReader of
``models/vlm.py`` on its device: decode the first image, letterbox it to the
model's page shape, and greedy-decode the metadata JSON. The prompt is
ignored: the model is the extractor. Downstream JSON repair and schema
validation in the extractor apply unchanged.

The page is loaded as the JAX client loads it, without Pillow: the image's
bytes through ``io.decode_rgb`` (the PNG reader, the C++ JPEG decoder),
Pillow's ``convert("L")`` luma (``io.pil_gray_u8``), an aspect-keeping
BILINEAR resize (``ops.pil_resample_u8``) and a white letterbox. The model
computes in bfloat16, the JAX client's type; a caller may set
``client._model`` to another ``PageReader`` (a float32 one, say) before the
first call, as with the JAX client. ``BB_OCR_VLM_CKPT`` names the default
checkpoint, and a ``model`` argument that is a file names the checkpoint
of that call.
"""

from __future__ import annotations

import base64
import os
import threading
from typing import List, Optional

import numpy as np
import torch

from bbocr_tpu_torch.io import load_gray
from bbocr_tpu_torch.llm.client import LLMClient
from bbocr_tpu_torch.ops.resize import pil_resample_u8

DEFAULT_CKPT = os.path.join("checkpoints", "vlm.npz")
PAGE_H, PAGE_W = 256, 192

# Process-wide client cache keyed by checkpoint path and device: the
# parameters live on the device, so re-creating a client per request (the
# extractor builds its LLM client per call) would re-read the ~19MB npz and
# re-upload the parameters every time. Mirrors the engine's _ENGINE_CACHE.
_CLIENT_CACHE: dict = {}
_CACHE_LOCK = threading.Lock()


def get_native_client(ckpt_path: Optional[str] = None, device="cuda") -> "NativeVLMClient":
    key = ckpt_path or os.environ.get("BB_OCR_VLM_CKPT", DEFAULT_CKPT)
    with _CACHE_LOCK:
        client = _CLIENT_CACHE.get((key, str(torch.device(device))))
        if client is None:
            client = _CLIENT_CACHE[(key, str(torch.device(device)))] = NativeVLMClient(key, device)
        return client


def letterbox_page(gray: np.ndarray) -> np.ndarray:
    """A gray image (whole values 0..255) -> the model's (PAGE_H, PAGE_W)
    float32 page: Pillow's BILINEAR resize keeping the aspect, at the top
    left of a white page."""
    h, w = gray.shape
    scale = min(PAGE_H / h, PAGE_W / w)
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    page = np.full((PAGE_H, PAGE_W), 255, np.float32)
    page[:nh, :nw] = pil_resample_u8(np.asarray(gray, np.uint8), nw, nh, "bilinear")
    return page


class NativeVLMClient(LLMClient):
    """LLMClient over the PageReader on ``device``. ``model`` names a
    checkpoint path (or anything else for the default
    ``checkpoints/vlm.npz``)."""

    def __init__(self, ckpt_path: Optional[str] = None, device="cuda"):
        self.ckpt_path = ckpt_path or os.environ.get("BB_OCR_VLM_CKPT", DEFAULT_CKPT)
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._model = None
        self._loaded: Optional[tuple] = None  # (path, model) the parameters were loaded for

    def _ensure_loaded(self, model_name: str):
        from bbocr_tpu_torch.models.vlm import PageReader
        from bbocr_tpu_torch.utils.checkpoint import load_params

        path = model_name if model_name and os.path.isfile(model_name) else self.ckpt_path
        if self._model is None:
            self._model = PageReader()
        # key the loaded parameters on the resolved path (a long-lived client
        # asked for a different checkpoint must not keep serving the first)
        # and on the model a caller may have set
        if self._loaded is None or self._loaded[0] != path or self._loaded[1] is not self._model:
            self._model.load_params(load_params(path)).to(self.device).eval()
            self._loaded = (path, self._model)

    @staticmethod
    def _page_from_b64(image_b64: str) -> np.ndarray:
        return letterbox_page(load_gray(base64.b64decode(image_b64)))

    def generate(self, model, prompt, images_b64: List[str], timeout_seconds=300.0) -> str:
        from bbocr_tpu_torch.models.vlm import decode_ids, greedy_generate

        if not images_b64:
            return "{}"
        with self._lock:
            self._ensure_loaded(model)
            page = torch.from_numpy(self._page_from_b64(images_b64[0]))[None, ..., None].to(self.device)
            ids = greedy_generate(self._model, page)
        return decode_ids(ids[0])
