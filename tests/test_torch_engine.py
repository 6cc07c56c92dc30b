"""The port's OCR engine and its host steps against the JAX engine, and
the port's extractor end to end, in float32 on the CPU."""

import dataclasses
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbocr_tpu.decode.boxes import extract_boxes_masked as jax_extract_boxes
from bbocr_tpu.runtime import rectify as jax_rectify
from bbocr_tpu.runtime.bucketing import CanvasSpec as JaxCanvasSpec
from bbocr_tpu.runtime.engine import EngineConfig as JaxEngineConfig
from bbocr_tpu.runtime.engine import OCREngine as JaxOCREngine
from bbocr_tpu.runtime.engine import _contrast_stretch as jax_contrast_stretch
from bbocr_tpu_torch.decode import DetectionParams, extract_boxes_masked, extract_boxes_masked_plain
from bbocr_tpu_torch.extract import BookMetadataExtractor, validate_metadata, validate_schema
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
from bbocr_tpu_torch.runtime import engine as port_engine
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec
from bbocr_tpu_torch.runtime.rectify import quad_to_rect_homography, warp_crops

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRAFT_NPZ = os.path.join(ROOT, "checkpoints", "craft.npz")
CRNN_NPZ = os.path.join(ROOT, "checkpoints", "crnn.npz")
BOOK1 = os.path.join(ROOT, "data", "real", "covers", "book1.png")
CANVAS = (416, 320)


@pytest.fixture(scope="module")
def cover_u8():
    """A 400x320 uint8 gray cover, as the engine receives it."""
    gray = cv2.cvtColor(load_rgb(BOOK1), cv2.COLOR_RGB2GRAY)
    return cv2.resize(gray, (320, 400), interpolation=cv2.INTER_AREA)


def _jax_engine(*args, **kwargs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BB_OCR_COMPILE_CACHE", "0")  # no compilation cache under HOME
        if args:
            return JaxOCREngine(*args, **kwargs)
        return JaxOCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, **kwargs)


@pytest.fixture(scope="module")
def engines(cover_u8):
    jax_engine = _jax_engine(config=JaxEngineConfig(
        canvases=(JaxCanvasSpec(*CANVAS),), compute_dtype=jnp.float32, host_rectify=False,
        wire_bits=8, decoder="greedy", detect_pool=1, detect_coarse=0,
    ))
    port = OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, EngineConfig(
        canvases=(CanvasSpec(*CANVAS),), compute_dtype=torch.float32,
    ), device="cpu")
    return jax_engine, port


@pytest.mark.parametrize(
    "src,dst",
    [((1312, 1050), (1080, 864)), ((70, 90), (50, 64)), ((33, 41), (66, 82)), ((875, 700), (1184, 947))],
    ids=["slice_downscale", "downscale", "upscale2x", "upscale"],
)
def test_host_resize_is_cv2_bilinear(src, dst):
    """The letterbox resize equals cv2.resize(INTER_LINEAR) bit for bit."""
    img = np.random.default_rng(0).integers(0, 256, src).astype(np.uint8)
    ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(port_engine._host_resize(img, *dst), ref)


def test_to_gray_u8_is_cv2():
    rgb = load_rgb(BOOK1)
    np.testing.assert_array_equal(port_engine._to_gray_u8(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
    floats = np.float32([[0.0, 1.9, 254.99, 300.0]])
    np.testing.assert_array_equal(port_engine._to_gray_u8(floats), np.uint8([[0, 1, 254, 255]]))


def test_native_boxes_match_plain_and_jax(engines, cover_u8):
    """The C++ labeler path equals the numpy path and the JAX package's."""
    _, port = engines
    canvas = np.zeros((1,) + CANVAS, np.float32)
    canvas[0, :400, :320] = cover_u8
    mask, region = (a[0].numpy() for a in port.detect(torch.from_numpy(canvas)))
    params = DetectionParams()
    native = extract_boxes_masked(mask, region, params)
    assert native, "the cover should give boxes"
    for other in (extract_boxes_masked_plain(mask, region, params), jax_extract_boxes(mask, region)):
        assert len(other) == len(native)
        np.testing.assert_allclose(np.stack(native), np.stack(other), atol=1e-6)


def test_warp_crops_match_jax(cover_u8):
    """Bilinear warp of the same quads, abs <= 1e-3 (float32 homography
    products summed in another order)."""
    images = np.stack([cover_u8, cover_u8[::-1]]).astype(np.float32)
    quads = [np.array([[10.0, 20], [200, 35], [195, 80], [5, 66]]), np.array([[50.0, 300], [300, 300], [300, 340], [50, 340]])]
    homos = np.stack([quad_to_rect_homography(q, 120) for q in quads]).astype(np.float32)
    idx = np.array([0, 1], np.int32)
    true_w = np.array([120, 100], np.int32)
    ref = np.asarray(jax_rectify.warp_crops(jnp.asarray(images), jnp.asarray(homos), jnp.asarray(idx), jnp.asarray(true_w), 128))
    got = warp_crops(torch.from_numpy(images), torch.from_numpy(homos), torch.from_numpy(idx), torch.from_numpy(true_w), 128)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)


def test_recognize_with_retry_matches_jax(engines, cover_u8):
    """The recognize program with the contrast-stretch retry forced
    (threshold 0.99): equal ids and lengths, confidences within 1e-4."""
    jax_engine, port = engines
    crops = np.stack([cover_u8[40:72, 20:148], cover_u8[200:232, 100:228], np.full((32, 128), 128, np.uint8)]).astype(np.float32)
    lengths = np.array([31, 20, 31], np.int32)
    valid = np.array([True, True, False])
    jstretch = np.asarray(jax_contrast_stretch(jnp.asarray(crops)))
    np.testing.assert_allclose(port_engine._contrast_stretch(torch.from_numpy(crops)).numpy(), jstretch, rtol=0, atol=1e-3)
    jax_forced = _jax_engine(jax_engine.craft_params, jax_engine.crnn_params,
                             dataclasses.replace(jax_engine.config, contrast_ths=0.99))
    port.config = dataclasses.replace(port.config, contrast_ths=0.99)
    try:
        ref = [np.asarray(a) for a in jax_forced._recognize(jax_forced.crnn_params, jnp.asarray(crops), jnp.asarray(lengths), jnp.asarray(valid))]
        got = [a.numpy() for a in port.recognize(torch.from_numpy(crops), torch.from_numpy(lengths), torch.from_numpy(valid))]
    finally:
        port.config = dataclasses.replace(port.config, contrast_ths=0.1)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-4, atol=1e-6)


def test_readtext_matches_jax_engine(engines, cover_u8):
    """Same box count, quads within 1 px, equal texts (float32 both)."""
    jax_engine, port = engines
    ref = jax_engine.readtext(cover_u8)
    got = port.readtext(cover_u8)
    assert len(ref) > 0 and len(got) == len(ref)
    for (q, t, c), (rq, rt, rc) in zip(got, ref):
        assert t == rt
        assert np.abs(q - rq).max() <= 1.0
        assert abs(c - rc) <= 1e-3
    assert set(port.timings()) == {"letterbox", "detect", "boxes", "rectify", "recognize"}


def test_readtext_bf16_matches_jax_engine(cover_u8):
    """The default bfloat16 engines of both packages. The port rounds where
    flax does (``models.layers``), but conv sums run in another order and
    XLA's fusions skip some roundings under ``jit``, so a detection score
    near the threshold can still flip and move a box edge by one map pixel:
    CRAFT's maps are at half resolution, so quads agree within 2 px. Every
    box must read the same text."""
    jax_engine = _jax_engine(config=JaxEngineConfig(
        canvases=(JaxCanvasSpec(*CANVAS),), compute_dtype=jnp.bfloat16, host_rectify=False,
        wire_bits=8, decoder="greedy", detect_pool=1, detect_coarse=0,
    ))
    port = OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, EngineConfig(canvases=(CanvasSpec(*CANVAS),)), device="cpu")
    assert port.config.compute_dtype == torch.bfloat16
    ref = jax_engine.readtext(cover_u8)
    got = port.readtext(cover_u8)
    assert len(ref) > 0 and len(got) == len(ref)
    for (q, t, _), (rq, rt, _) in zip(got, ref):
        assert np.abs(q - rq).max() <= 2.0
        assert t == rt


def test_extractor_makes_valid_json(engines, tmp_path):
    _, port = engines
    rgb = load_rgb(BOOK1)[::2, ::2]
    extractor = BookMetadataExtractor(
        llm_backend="heuristic", auto_rotate=False, reread_low_conf=False,
        isbn_reread=False, fast_single=False, warm_model=False, device="cpu", engine=port,
    )
    meta = extractor.extract_metadata_from_images([rgb], ocr_image_indices=[0])
    validate_schema(meta)
    assert validate_metadata(meta)[1] in ([], ["Missing title"])
    info = meta["_processing_info"]
    assert info["structurer"] == "heuristic" and info["ocr_boxes"] > 0


@pytest.mark.parametrize(
    "kwargs",
    [
        {"llm_backend": "ollama"},
        {"crop_for_ocr": True},
        {"isbn_reread": True},
        {"reread_low_conf": True},
        {"auto_rotate": True},
        {"fast_single": True},
    ],
    ids=["llm", "autocrop", "isbn_reread", "reread", "rotate", "fast"],
)
def test_extractor_refuses_unported_knobs(kwargs):
    base = dict(llm_backend="heuristic", auto_rotate=False, reread_low_conf=False, isbn_reread=False, fast_single=False)
    base.update(kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        BookMetadataExtractor(**base)


def test_extractor_refuses_auto_rotate_resolving_true():
    extractor = BookMetadataExtractor(
        llm_backend="heuristic", reread_low_conf=False, isbn_reread=False, fast_single=False, device="cpu",
    )
    with pytest.raises(NotImplementedError, match="rotations"):
        extractor._ocr_text(np.zeros((1300, 900), np.float32), 0)


@pytest.mark.parametrize(
    "kwargs",
    [{"host_rectify": True}, {"wire_bits": 4}],
    ids=["host_rectify", "wire_bits"],
)
def test_engine_refuses_unported_options(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        OCREngine({"params": {}}, {"params": {}}, EngineConfig(**kwargs), device="cpu")
