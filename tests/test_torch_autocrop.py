"""The port's auto-crop and the ops it needs against the JAX package's, on
the CPU.

- Each op against its JAX op run eagerly on seeded uint8 images (odd and
  even kernel sizes, images smaller than the kernel, edges): masks and
  uint8-valued outputs bit-exact, float outputs within 1e-4.
- ``text_mask`` bit-exact with the JAX one on a cover; on ``book1.png`` the
  jitted JAX ``text_mask`` differs from its eager self, which the port
  equals, on 4 composite pixels (pinned, ROADMAP Queue 3); the morphed mask
  is equal.
- ``auto_crop_text_region`` on the five preprocessed covers: the JAX
  package's rectangles, recorded by ``scripts/torch_port_reference.py
  --autocrop`` in ``tests/data/autocrop_jax_f32.json``.
- The extractor with ``crop_for_ocr=True`` on the five covers at one
  640x480 canvas (float32, device warps, greedy decode, rotations, re-reads
  and the fast path off): the JAX extractor's JSON, recorded in
  ``tests/data/autocrop_jax_f32_640x480.json``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbocr_tpu import ops as jax_ops
from bbocr_tpu.ops.histogram import otsu_threshold_value as jax_otsu_threshold_value
from bbocr_tpu.preprocess.autocrop import text_mask as jax_text_mask
from bbocr_tpu_torch import ops
from bbocr_tpu_torch.extract import BookMetadataExtractor, empty_metadata
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.native import connected_components, connected_components_numpy
from bbocr_tpu_torch.preprocess import auto_crop_text_region, preprocess_for_book_cover, text_mask
from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
COVERS = [os.path.join("data", "real", "covers", f"book{i}.png") for i in (1, 2, 4, 5, 6)]
SHAPES = [(37, 53), (64, 48), (5, 7), (1, 1)]


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)


def _same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return got.shape == want.shape and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_filters_and_thresholds_match_jax(shape):
    x = _u8(shape, sum(shape))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for k in (5, 4, 35):
        assert np.abs(ops.box_blur(xt, k).numpy() - np.asarray(jax_ops.box_blur(xj, k))).max() <= 1e-4
    assert _same(ops.sobel_magnitude_u8(xt), jax_ops.sobel_magnitude_u8(xj))
    for method, block, c in (("mean", 35, 10), ("gaussian", 31, 5), ("mean", 4, 2), ("gaussian", 3, 0)):
        for inverse in (True, False):
            assert _same(ops.adaptive_threshold(xt, 255.0, method, block, c, inverse),
                         jax_ops.adaptive_threshold(xj, 255.0, method, block, c, inverse)), (method, block, inverse)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_histogram_ops_match_jax(shape):
    x = _u8(shape, 7 + sum(shape))
    x[: shape[0] // 2] = np.minimum(x[: shape[0] // 2], 40)  # a dark half: two modes
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    assert _same(ops.equalize_hist(xt), jax_ops.equalize_hist(xj))
    assert float(ops.otsu_threshold_value(xt)) == float(jax_otsu_threshold_value(xj))
    for inverse in (True, False):
        assert _same(ops.otsu_threshold(xt, 255.0, inverse), jax_ops.otsu_threshold(xj, 255.0, inverse))
    stack = np.stack([x, 255 - x])  # leading batch axis
    assert _same(ops.equalize_hist(torch.from_numpy(stack)), jax_ops.equalize_hist(jnp.asarray(stack)))


@pytest.mark.parametrize("ksize,iterations", [((9, 3), 2), ((15, 5), 2), ((3, 3), 1), ((11, 3), 1), ((4, 2), 1), ((2, 6), 3)])
def test_morphology_matches_jax(ksize, iterations):
    """Rectangular windows, odd and even; the (15, 5) close with 2
    iterations is the auto-crop's asymmetric-padding case."""
    x = _u8((41, 58), ksize[0] * 10 + ksize[1])
    binary = np.where(x > 170, 255.0, 0.0).astype(np.float32)
    for img in (x, binary):
        xt, xj = torch.from_numpy(img), jnp.asarray(img)
        assert _same(ops.erode(xt, ksize, iterations), jax_ops.erode(xj, ksize, iterations))
        assert _same(ops.dilate(xt, ksize, iterations), jax_ops.dilate(xj, ksize, iterations))
        assert _same(ops.morph_close(xt, ksize, iterations), jax_ops.morph_close(xj, ksize, iterations))
        assert _same(ops.morph_open(xt, ksize, iterations), jax_ops.morph_open(xj, ksize, iterations))


@pytest.mark.parametrize("src,dst", [((37, 53), (75, 159)), ((64, 48), (64, 48)), ((5, 7), (11, 21))])
def test_resize_bilinear_matches_jax(src, dst):
    """Float output: within 1e-4 (the products sum in another order)."""
    x = _u8(src, 3)
    got = ops.resize_bilinear(torch.from_numpy(x), *dst)
    want = np.asarray(jax_ops.resize_bilinear(jnp.asarray(x), *dst))
    assert got.shape == want.shape and np.abs(got.numpy() - want).max() <= 1e-4
    assert _same(ops.resize_bilinear(torch.from_numpy(x), *dst, quantize=True),
                 jax_ops.resize_bilinear(jnp.asarray(x), *dst, quantize=True))


def test_connected_components_native_is_plain():
    mask = _u8((61, 77), 11) > 200
    score = _u8((61, 77), 12) / 255.0
    labels, stats = connected_components(mask, score)
    ref_labels, ref_stats = connected_components_numpy(mask, score)
    assert np.array_equal(labels, ref_labels)
    assert np.allclose(stats, ref_stats, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def preprocessed():
    """The five covers through the port's preprocessing (CPU)."""
    return {rel: preprocess_for_book_cover(load_rgb(os.path.join(ROOT, rel)), device="cpu")[0] for rel in COVERS}


def test_text_mask_matches_jax(preprocessed):
    pre = preprocessed[COVERS[1]].numpy()  # book2
    ref = [np.asarray(m) for m in jax_text_mask(jnp.asarray(pre))]
    got = text_mask(torch.from_numpy(pre))
    assert all(_same(g, r) for g, r in zip(got, ref))
    assert 0 < float(got[0].mean()) < 1


def test_text_mask_differs_from_jitted_jax_on_four_pixels(preprocessed):
    """On ``book1.png`` the jitted JAX ``text_mask`` differs on 4 pixels of
    the composite mask from the same function run eagerly (XLA fuses the
    chain; seen with ``jax.disable_jit()``, which takes about 15 s here), and
    the port equals the eager one. The morphed mask, from which the crop
    rectangle comes, is equal."""
    jitted = [np.asarray(m) for m in jax_text_mask(jnp.asarray(preprocessed[COVERS[0]].numpy()))]
    got = [m.numpy() for m in text_mask(preprocessed[COVERS[0]])]
    assert np.array_equal(got[0], jitted[0])
    assert int((got[1] != jitted[1]).sum()) == 4


@pytest.fixture(scope="module")
def autocrop_reference():
    with open(os.path.join(DATA, "autocrop_jax_f32.json")) as f:
        return json.load(f)["photos"]


@pytest.mark.parametrize("rel", COVERS, ids=[os.path.basename(p) for p in COVERS])
def test_auto_crop_rectangle_matches_jax(preprocessed, autocrop_reference, rel):
    ref = autocrop_reference[rel]
    pre = preprocessed[rel]
    assert list(pre.shape) == ref["preprocessed_shape"]
    rect = auto_crop_text_region(pre.numpy(), 128, device="cpu")
    assert (None if rect is None else list(rect)) == ref["rect"]


@pytest.fixture(scope="module")
def crop_route_reference():
    with open(os.path.join(DATA, "autocrop_jax_f32_640x480.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small_engine():
    return OCREngine.from_checkpoint(
        os.path.join(ROOT, "checkpoints", "craft.npz"), os.path.join(ROOT, "checkpoints", "crnn.npz"),
        EngineConfig(canvases=(CanvasSpec(640, 480),), compute_dtype=torch.float32, host_rectify=False,
                     decoder="greedy"),
        device="cpu",
    )


@pytest.mark.parametrize("rel", COVERS, ids=[os.path.basename(p) for p in COVERS])
def test_crop_for_ocr_extractor_matches_jax(crop_route_reference, small_engine, rel):
    """The same metadata JSON, ``_processing_info`` aside, as the JAX
    extractor with ``crop_for_ocr=True`` and its default margin (128)."""
    assert crop_route_reference["knobs"]["crop_for_ocr"] and crop_route_reference["canvas"] == [640, 480]
    extractor = BookMetadataExtractor(
        llm_backend="heuristic", crop_for_ocr=True, auto_rotate=False, reread_low_conf=False, isbn_reread=False,
        fast_single=False, device="cpu", engine=small_engine,
    )
    got = extractor.extract_metadata_from_images([os.path.join(ROOT, rel)], ocr_image_indices=[0])
    got.pop("_processing_info")
    assert got == crop_route_reference["photos"][rel]["meta"]


class _OneBoxEngine:
    """Fake engine: every image reads as one confident box."""

    def readtext(self, image):
        return [(np.float32([[10, 10], [90, 10], [90, 30], [10, 30]]), "Title", 0.9)]

    def timings(self):
        return {}


def test_debug_autocrop_returns_the_stub(monkeypatch):
    """``BB_OCR_DEBUG_AUTOCROP``: no crop, OCR still runs, an all-null stub
    with the JAX extractor's flags comes back."""
    monkeypatch.setenv("BB_OCR_DEBUG_AUTOCROP", "1")
    extractor = BookMetadataExtractor(llm_backend="heuristic", crop_for_ocr=True, auto_rotate=False,
                                      fast_single=False, device="cpu", engine=_OneBoxEngine())
    rgb = load_rgb(os.path.join(ROOT, COVERS[1]))
    assert "auto_cropped" not in extractor._process_image(rgb)
    out = extractor.extract_metadata_from_images([rgb], ocr_image_indices=[0])
    info = out.pop("_processing_info")
    assert info["debug_autocrop"] and info["model_skipped"] and info["ocr_images_processed"] == 1
    assert out == empty_metadata()
