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
        canvases=(CanvasSpec(*CANVAS),), compute_dtype=torch.float32, host_rectify=False, decoder="greedy",
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


@pytest.mark.parametrize("shape", [(8, 32, 64), (8, 32, 512), (32, 32, 256), (3, 32, 384)])
def test_recognizer_input_is_the_jax_engines(shape):
    """What the CRNN receives equals what the JAX engine's compiled program
    gives it, bit for bit: the contrast stretch (its percentiles' index and
    fused interpolation) and the [-1, 1] input in bfloat16 (a fused
    multiply-add by the reciprocal of 127.5)."""
    import jax

    crops = np.random.default_rng(shape[2]).normal(128, 60, shape).clip(0, 255).astype(np.float32)
    crops[0] = np.round(crops[0])  # integer levels, as a plain crop of a u8 canvas holds
    ref = np.asarray(jax.jit(lambda c: jax_contrast_stretch(c))(jnp.asarray(crops)))
    got = port_engine._contrast_stretch(torch.from_numpy(crops))
    np.testing.assert_array_equal(got.numpy(), ref)
    to_input = jax.jit(lambda c: (c / 127.5 - 1.0).astype(jnp.bfloat16).astype(jnp.float32))
    for c, t in ((crops, torch.from_numpy(crops)), (ref, got)):
        ours = port_engine._to_unit_range(t).to(torch.bfloat16).float()
        np.testing.assert_array_equal(ours.numpy(), np.asarray(to_input(jnp.asarray(c))))


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
    port = OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, EngineConfig(
        canvases=(CanvasSpec(*CANVAS),), host_rectify=False, decoder="greedy"), device="cpu")
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
    ],
    ids=["llm"],
)
def test_extractor_refuses_unported_knobs(kwargs):
    base = dict(llm_backend="heuristic", auto_rotate=False, reread_low_conf=False, isbn_reread=False, fast_single=False)
    base.update(kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        BookMetadataExtractor(**base)


class _ShapeEngine:
    """Fake engine that records the shape of every image it reads."""

    def __init__(self):
        self.shapes = []

    def readtext(self, image):
        self.shapes.append(image.shape)
        return []


@pytest.mark.parametrize(
    "auto_rotate,shape,reads",
    [
        (None, (1300, 900), [(1300, 900), (900, 1300), (1300, 900), (900, 1300)]),  # camera-shaped: rotations
        (True, (800, 600), [(800, 600), (600, 800), (800, 600), (600, 800)]),  # small, but asked for
        (False, (1300, 900), [(1300, 900)]),
        (None, (2000, 1000), [(1600, 800), (800, 1600), (1600, 800), (800, 1600)]),  # downscaled first
    ],
    ids=["auto_camera", "asked_small", "off", "auto_downscaled"],
)
def test_extractor_auto_rotate_takes_the_rotation_route(auto_rotate, shape, reads):
    """``auto_rotate=None`` resolves as in the JAX extractor (rotations for a
    long side of 1200 px or more) and the rotation route reads the image at
    k = 0, 1, 2, 3; the fast path stays off when rotating."""
    engine = _ShapeEngine()
    extractor = BookMetadataExtractor(
        llm_backend="heuristic", auto_rotate=auto_rotate, reread_low_conf=False, isbn_reread=False,
        fast_single=None if auto_rotate is not False else False, device="cpu", engine=engine,
    )
    extractor._ocr_text(np.zeros(shape, np.float32), 0)
    assert engine.shapes == reads


@pytest.mark.parametrize(
    "craft_tree",
    [{"slice1": {}}, {"LiteBackbone_0": {}}],
    ids=["published", "lite"],
)
def test_engine_refuses_unported_options(craft_tree):
    """The published CRAFT layout and CRAFTLite are ported: a tree of
    either layout is sniffed to its detector, whose strict loading refuses
    an incomplete tree (naming that detector's parameters)."""
    name = "slice1.convs.0.weight" if "slice1" in craft_tree else "backbone.stem.weight"
    with pytest.raises(RuntimeError, match=name.replace(".", r"\.")):
        OCREngine({"params": craft_tree}, {"params": {}}, EngineConfig(fold_gray_stem=False), device="cpu")


@pytest.mark.parametrize(
    "env",
    [{}, {"BB_OCR_DECODER": "beam", "BB_OCR_HOST_RECTIFY": "0"}, {"BB_OCR_HOST_RECTIFY": "false"},
     {"BB_OCR_HOST_RECTIFY": "yes"}, {"BB_OCR_WIRE_BITS": "4", "BB_OCR_DETECT_COARSE": "2"},
     {"BB_OCR_WIRE_BITS": "2", "BB_OCR_DECODER": "beam"}],
    ids=["defaults", "beam_device_warp", "false", "yes", "wire4_coarse2", "wire2_beam"],
)
def test_engine_config_defaults_match_jax(monkeypatch, env):
    """``EngineConfig()`` equals the JAX one on every field, in the same
    order, reading ``BB_OCR_DECODER``, ``BB_OCR_HOST_RECTIFY``,
    ``BB_OCR_WIRE_BITS`` and ``BB_OCR_DETECT_COARSE`` when it is
    constructed."""
    for name in ("BB_OCR_DECODER", "BB_OCR_HOST_RECTIFY", "BB_OCR_WIRE_BITS", "BB_OCR_DETECT_COARSE",
                 "BB_OCR_CANVAS_XL"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ours, ref = EngineConfig(), JaxEngineConfig()
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ours):
        got, want = getattr(ours, f.name), getattr(ref, f.name)
        if f.name == "canvases":
            got, want = [(c.height, c.width) for c in got], [(c.height, c.width) for c in want]
        elif f.name == "detection":  # the JAX one adds use_native
            got, want = dataclasses.asdict(got), {k: getattr(want, k) for k in dataclasses.asdict(got)}
        elif f.name == "compute_dtype":
            got, want = str(got).split(".")[-1], jnp.dtype(want).name
        assert got == want, f.name


def test_readtext_host_rectify_matches_jax_engine(cover_u8):
    """Both engines with their default host rectification (crops warped
    from the original photo), float32: the same boxes, quads within 1 px,
    equal texts, confidences within 1e-3."""
    jax_engine = _jax_engine(config=JaxEngineConfig(
        canvases=(JaxCanvasSpec(*CANVAS),), compute_dtype=jnp.float32, host_rectify=True,
        wire_bits=8, decoder="greedy", detect_pool=1, detect_coarse=0,
    ))
    port = OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, EngineConfig(
        canvases=(CanvasSpec(*CANVAS),), compute_dtype=torch.float32, host_rectify=True, decoder="greedy",
    ), device="cpu")
    image = cv2.resize(cover_u8, (480, 600), interpolation=cv2.INTER_CUBIC)  # finer than the canvas
    ref = jax_engine.readtext(image)
    got = port.readtext(image)
    assert len(ref) > 0 and len(got) == len(ref)
    for (q, t, c), (rq, rt, rc) in zip(got, ref):
        assert t == rt
        assert np.abs(q - rq).max() <= 1.0
        assert abs(c - rc) <= 1e-3


def test_recognize_with_beam_decoder_matches_jax(engines, cover_u8):
    """``decoder="beam"``: the recognize program decodes with the device
    prefix beam, confidence exp(score); the contrast retry is forced.
    Equal ids and lengths, confidences within 1e-4."""
    jax_engine, port = engines
    crops = np.stack([cover_u8[40:72, 20:148], cover_u8[200:232, 100:228], np.full((32, 128), 128, np.uint8)]).astype(np.float32)
    lengths = np.array([31, 20, 31], np.int32)
    valid = np.array([True, True, False])
    jax_beam = _jax_engine(jax_engine.craft_params, jax_engine.crnn_params,
                           dataclasses.replace(jax_engine.config, decoder="beam", contrast_ths=0.99))
    port.config = dataclasses.replace(port.config, decoder="beam", contrast_ths=0.99)
    try:
        ref = [np.asarray(a) for a in jax_beam._recognize(jax_beam.crnn_params, jnp.asarray(crops), jnp.asarray(lengths), jnp.asarray(valid))]
        got = [a.numpy() for a in port.recognize(torch.from_numpy(crops), torch.from_numpy(lengths), torch.from_numpy(valid))]
    finally:
        port.config = dataclasses.replace(port.config, decoder="greedy", contrast_ths=0.1)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-4, atol=1e-6)


class _RouteEngine:
    """Fake engine recording the calls of the extractor's OCR route; its
    re-reads can be told to fail."""

    def __init__(self, fail=None):
        self.calls, self.fail = [], fail

    def _results(self):
        return [(np.float32([[10, 10], [200, 10], [200, 40], [10, 40]]), "ISBN 978O3I6769488", 0.3),
                (np.float32([[10, 60], [150, 60], [150, 90], [10, 90]]), "The Title", 0.9)]

    def readtext(self, image):
        self.calls.append(("readtext", image.shape))
        return self._results()

    def readtext_fast(self, image):
        self.calls.append(("fast", image.shape))
        return self._results()

    def reread_low_conf(self, image, results, conf_ths):
        self.calls.append(("reread", image.shape, conf_ths, len(results)))
        if self.fail == "reread":
            raise RuntimeError("re-read failed")
        return [(q, t.replace("O3I", "031"), c) for q, t, c in results]

    def reread_isbn(self, image, results):
        self.calls.append(("isbn", image.shape, [t for _, t, _ in results]))
        if self.fail == "isbn":
            raise RuntimeError("ISBN re-read failed")
        return "9780316769488"

    def timings(self):
        return {}


@pytest.mark.parametrize("shape", [(1300, 900), (800, 600), (2000, 1000)], ids=["camera", "small", "downscaled"])
def test_extractor_default_route_calls_as_jax(shape):
    """With its defaults the extractor takes the JAX extractor's route:
    rotations (re-read of the winner inside) for camera-shaped photos, the
    fast path then the re-read for small upright ones, then the ISBN re-read
    on the unrotated image; the ISBN becomes its own line."""
    from bbocr_tpu.extract.extractor import BookMetadataExtractor as JaxExtractor

    image = np.random.default_rng(0).integers(0, 256, shape).astype(np.float32)
    ours, ref = _RouteEngine(), _RouteEngine()
    got = BookMetadataExtractor(llm_backend="heuristic", device="cpu", engine=ours)._ocr_text(image, 0)
    exp = JaxExtractor(llm_backend="heuristic", engine=ref)._ocr_text(image, 0)
    assert ours.calls == ref.calls
    assert ours.calls[-1][0] == "isbn" and ours.calls[-2][0] == "reread"
    assert ("fast" in ours.calls[0]) == (shape == (800, 600))
    assert got[:3] == exp
    assert "ISBN 9780316769488" in got[1]


@pytest.mark.parametrize("fail", ["reread", "isbn"])
def test_extractor_rereads_propagate_errors(fail):
    """A raising re-read does not reach the caller, as in the JAX extractor:
    a failed low-confidence re-read keeps the first reading, a failed ISBN
    re-read adds no ISBN line; the same calls and the same text as JAX."""
    from bbocr_tpu.extract.extractor import BookMetadataExtractor as JaxExtractor

    image = np.zeros((800, 600), np.float32)
    ours, ref = _RouteEngine(fail), _RouteEngine(fail)
    exp = JaxExtractor(llm_backend="heuristic", engine=ref)._ocr_text(image, 0)
    got = BookMetadataExtractor(llm_backend="heuristic", device="cpu", engine=ours)._ocr_text(image, 0)
    assert ours.calls == ref.calls and got[:3] == exp
    assert (got[1][-1] == "ISBN 9780316769488") == (fail != "isbn")
    assert ("978O3I6769488" in " ".join(info[0] for info in got[2])) == (fail == "reread")
