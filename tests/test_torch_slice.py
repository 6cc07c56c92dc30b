"""The port's slice as a whole against the JAX package's, on the CPU.

- ``book1.png`` at full size (1312x1050 after preprocessing, the 1184x864
  canvas) read through the port in float32 and in bfloat16, held to the
  JAX package's recorded readings (``tests/data/book1_jax_f32.json`` and
  ``book1_jax_bf16.json``, written by ``scripts/torch_port_reference.py``).
- The metadata JSON of both extractors on the five covers of
  ``data/real/covers/`` (heuristic backend, float32 engines, rotations,
  re-reads and the fast path off, one 640x480 canvas).
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbocr_tpu.extract.extractor import BookMetadataExtractor as JaxExtractor
from bbocr_tpu.runtime.bucketing import CanvasSpec as JaxCanvasSpec
from bbocr_tpu.runtime.engine import EngineConfig as JaxEngineConfig
from bbocr_tpu.runtime.engine import OCREngine as JaxOCREngine
from bbocr_tpu_torch.extract import BookMetadataExtractor
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.preprocess import preprocess_for_book_cover
from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRAFT_NPZ = os.path.join(ROOT, "checkpoints", "craft.npz")
CRNN_NPZ = os.path.join(ROOT, "checkpoints", "crnn.npz")
BOOK1 = os.path.join(ROOT, "data", "real", "covers", "book1.png")
COVERS = sorted(glob.glob(os.path.join(ROOT, "data", "real", "covers", "*.png")))
CANVAS = (640, 480)


@pytest.mark.parametrize(
    "dtype,reference,boxes,quad_px",
    [
        (torch.float32, "book1_jax_f32.json", 11, 1.0),
        # CRAFT's bfloat16 maps differ by a few ulps (conv sums in another
        # order), which moves box 6 by 2.4477 px and box 8 by 0.41 px; map
        # pixels are 2 image pixels
        (torch.bfloat16, "book1_jax_bf16.json", 9, 2.5),
    ],
    ids=["float32", "bfloat16"],
)
def test_book1_full_size_matches_jax_reading(dtype, reference, boxes, quad_px):
    """The same box count and texts as the JAX package's reading, quads
    within ``quad_px``."""
    with open(os.path.join(ROOT, "tests", "data", reference)) as f:
        ref = json.load(f)
    pre = preprocess_for_book_cover(load_rgb(BOOK1), device="cpu")[0].numpy()
    assert pre.shape == (1312, 1050)
    engine = OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, EngineConfig(compute_dtype=dtype), device="cpu")
    got = engine.readtext(pre)
    assert len(got) == len(ref["texts"]) == boxes
    assert [t for _, t, _ in got] == ref["texts"]
    for (q, _, _), rq in zip(got, ref["quads"]):
        assert np.abs(np.asarray(q) - np.asarray(rq)).max() <= quad_px


@pytest.fixture(scope="module")
def extractors():
    knobs = dict(llm_backend="heuristic", auto_rotate=False, reread_low_conf=False, isbn_reread=False,
                 fast_single=False, warm_model=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BB_OCR_COMPILE_CACHE", "0")  # no compilation cache under HOME
        jax_engine = JaxOCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, config=JaxEngineConfig(
            canvases=(JaxCanvasSpec(*CANVAS),), compute_dtype=jnp.float32, host_rectify=False,
            wire_bits=8, decoder="greedy", detect_pool=1, detect_coarse=0,
        ))
    port = OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, EngineConfig(
        canvases=(CanvasSpec(*CANVAS),), compute_dtype=torch.float32,
    ), device="cpu")
    return JaxExtractor(engine=jax_engine, **knobs), BookMetadataExtractor(engine=port, device="cpu", **knobs)


@pytest.mark.parametrize("path", COVERS, ids=[os.path.basename(p) for p in COVERS])
def test_cover_metadata_matches_jax_extractor(extractors, path):
    """The same metadata JSON, ``_processing_info`` aside (it names the
    engine, and the port adds ``ocr_boxes``)."""
    jax_extractor, port = extractors
    ref = jax_extractor.extract_metadata_from_images([path], ocr_image_indices=[0])
    got = port.extract_metadata_from_images([path], ocr_image_indices=[0])
    ref.pop("_processing_info")
    got.pop("_processing_info")
    assert got == ref
