"""The port's slice as a whole against the JAX package's, on the CPU.

- ``book1.png`` at full size (1312x1050 after preprocessing, the 1184x864
  canvas) read through the port in float32 and in bfloat16, held to the
  JAX package's recorded readings (``tests/data/book1_jax_f32.json`` and
  ``book1_jax_bf16.json``, written by ``scripts/torch_port_reference.py``).
- The metadata JSON of the port's extractor on the five covers of
  ``data/real/covers/`` (heuristic backend, float32 engine, one 640x480
  canvas) against the JAX extractor's, recorded by
  ``scripts/torch_port_reference.py``: with rotations, re-reads and the
  fast path off and device warps (``covers_jax_f32_640x480.json``,
  ``--covers``), and on the default route, with host rectification
  (``default_route_jax_f32_640x480.json``, ``--default-route --canvas
  640x480``): rotations for ``book1``, ``book5`` and ``book6``, the fast
  path for ``book2`` and ``book4``, then both re-reads. The live
  comparisons of the extractor against the JAX one are in
  ``tests/test_torch_orient.py``.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

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
DATA = os.path.join(ROOT, "tests", "data")


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
    engine = OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, EngineConfig(
        compute_dtype=dtype, host_rectify=False, decoder="greedy"), device="cpu")
    got = engine.readtext(pre)
    assert len(got) == len(ref["texts"]) == boxes
    assert [t for _, t, _ in got] == ref["texts"]
    for (q, _, _), rq in zip(got, ref["quads"]):
        assert np.abs(np.asarray(q) - np.asarray(rq)).max() <= quad_px


def _engine(host_rectify: bool) -> OCREngine:
    return OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, EngineConfig(
        canvases=(CanvasSpec(*CANVAS),), compute_dtype=torch.float32, host_rectify=host_rectify, decoder="greedy",
    ), device="cpu")


@pytest.fixture(scope="module")
def covers_reference():
    with open(os.path.join(DATA, "covers_jax_f32_640x480.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def default_route_reference():
    with open(os.path.join(DATA, "default_route_jax_f32_640x480.json")) as f:
        return json.load(f)


def _meta(extractor, path):
    got = extractor.extract_metadata_from_images([path], ocr_image_indices=[0])
    got.pop("_processing_info")
    return got


@pytest.mark.parametrize("path", COVERS, ids=[os.path.basename(p) for p in COVERS])
def test_cover_metadata_matches_jax_extractor(covers_reference, path):
    """The same metadata JSON, ``_processing_info`` aside (it names the
    engine, and the port adds ``ocr_boxes``)."""
    port = BookMetadataExtractor(
        engine=_engine(host_rectify=False), device="cpu", llm_backend="heuristic", auto_rotate=False,
        reread_low_conf=False, isbn_reread=False, fast_single=False, warm_model=False,
    )
    ref = covers_reference["photos"][os.path.relpath(path, ROOT)]["meta"]
    assert _meta(port, path) == ref


@pytest.mark.parametrize("path", COVERS, ids=[os.path.basename(p) for p in COVERS])
def test_cover_default_route_matches_jax_extractor(default_route_reference, path):
    """``BookMetadataExtractor(llm_backend="heuristic")`` with no other
    knob: the same metadata JSON as the JAX extractor's default route, and
    the same route (rotations or the fast path)."""
    ref = default_route_reference["photos"][os.path.relpath(path, ROOT)]
    engine = _engine(host_rectify=True)
    reads = []
    readtext, readtext_fast = engine.readtext, engine.readtext_fast
    engine.readtext = lambda image: reads.append("readtext") or readtext(image)
    engine.readtext_fast = lambda image: reads.append("fast") or readtext_fast(image)
    assert _meta(BookMetadataExtractor(llm_backend="heuristic", engine=engine, device="cpu"), path) == ref["meta"]
    assert reads == (["readtext"] * 4 if ref["route"] == "rotations" else ["fast"])
