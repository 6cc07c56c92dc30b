"""The port's rotation handling (``bbocr_tpu_torch.runtime.orient``) against
the JAX package's ``bbocr_tpu.runtime.orient``, on the CPU: the scores, the
zoom and the re-read of the winning rotation on hand-made result lists,
then ``read_with_rotations`` and the extractor with ``auto_rotate`` on,
with float32 engines at one small canvas, on ``book1.png`` halved, upright
and turned a quarter; last the extractor's default route (host
rectification, rotations, both re-reads) on the turned cover."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbocr_tpu.extract.extractor import BookMetadataExtractor as JaxExtractor
from bbocr_tpu.runtime import orient as jax_orient
from bbocr_tpu.runtime.bucketing import CanvasSpec as JaxCanvasSpec
from bbocr_tpu.runtime.engine import EngineConfig as JaxEngineConfig
from bbocr_tpu.runtime.engine import OCREngine as JaxOCREngine
from bbocr_tpu_torch.extract import BookMetadataExtractor
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
from bbocr_tpu_torch.runtime import orient
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec
from bbocr_tpu_torch.runtime.engine import _to_gray_u8

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRAFT_NPZ = os.path.join(ROOT, "checkpoints", "craft.npz")
CRNN_NPZ = os.path.join(ROOT, "checkpoints", "crnn.npz")
BOOK1 = os.path.join(ROOT, "data", "real", "covers", "book1.png")
CANVAS = (416, 320)


def _quad(x0, y0, x1, y1):
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32)


# Hand-made readtext results: confident words, low-confidence fragments,
# digit junk, short reads, empty and blank texts.
RESULTS = {
    "empty": [],
    "confident": [(_quad(10, 10, 90, 30), "Harry Potter", 0.93), (_quad(12, 40, 70, 55), "and the", 0.62)],
    "low_conf_words": [(_quad(5, 5, 60, 20), "to four of ny frienas", 0.05), (_quad(5, 25, 40, 35), "coueogles", 0.1)],
    "junk": [(_quad(0, 0, 5, 5), "1", 0.9), (_quad(7, 7, 20, 20), "3%7", 0.45), (_quad(30, 3, 50, 9), "  ab ", 0.8),
             (_quad(60, 60, 90, 70), "12a4", 0.2), (_quad(1, 80, 2, 81), "", 0.0)],
    "mixed": [(_quad(100, 100, 300, 140), "FIRST EDITION", 0.41), (_quad(100, 150, 280, 170), "isbn 0-8118", 0.39),
              (_quad(400, 10, 420, 400), "lllll", 0.02), (_quad(90, 200, 310, 230), "Printed in", 0.4)],
}


@pytest.mark.parametrize("name", sorted(RESULTS))
def test_scores_match_jax(name):
    res = RESULTS[name]
    assert orient.rotation_score(res) == jax_orient.rotation_score(res)
    assert orient._wordlike_mass(res) == jax_orient._wordlike_mass(res)


class _CropEngine:
    """Fake engine for ``zoom_reread``: records the crop it is asked to read
    and answers a fixed result list in the crop's frame."""

    def __init__(self, answer):
        self.answer = answer
        self.crops = []

    def readtext(self, img):
        self.crops.append(np.array(img))
        return self.answer


@pytest.mark.parametrize(
    "name,answer",
    [
        ("mixed", [(_quad(4, 4, 150, 30), "FIRST CHRONICLE BOOKS EDITION", 0.8)]),  # zoom wins
        ("mixed", [(_quad(4, 4, 20, 10), "x", 0.1)]),  # zoom loses
        ("low_conf_words", [(_quad(2, 2, 50, 12), "to four of my friends", 0.3)]),
        ("junk", [(_quad(1, 1, 9, 9), "word", 0.9)]),  # no credible quad: largest detection
        ("confident", []),  # union box too large for the frame: no zoom
        ("empty", []),
    ],
    ids=["zoom_wins", "zoom_loses", "low_conf", "largest_detection", "too_large", "empty"],
)
def test_zoom_reread_matches_jax(name, answer):
    h, w = (120, 100) if name == "confident" else (600, 800)
    img = np.random.default_rng(0).integers(0, 256, (h, w)).astype(np.uint8)
    ours, ref = _CropEngine(answer), _CropEngine(answer)
    got, zoomed = orient.zoom_reread(ours, img, RESULTS[name])
    exp, exp_zoomed = jax_orient.zoom_reread(ref, img, RESULTS[name])
    assert zoomed == exp_zoomed
    assert len(ours.crops) == len(ref.crops)
    for a, b in zip(ours.crops, ref.crops):
        np.testing.assert_array_equal(a, b)
    assert [t for _, t, _ in got] == [t for _, t, _ in exp]
    for (q, _, c), (rq, _, rc) in zip(got, exp):
        np.testing.assert_array_equal(np.asarray(q), np.asarray(rq))
        assert c == rc


@pytest.mark.parametrize("value", [None, "0", "", "false", "False", "1", "yes"])
def test_auto_zoom_flag_reads_like_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("BB_OCR_AUTO_ZOOM", raising=False)
    else:
        monkeypatch.setenv("BB_OCR_AUTO_ZOOM", value)
    assert orient._auto_zoom_enabled() == jax_orient._auto_zoom_enabled()


class _RotationEngine:
    """Fake engine: reads each rotation as a fixed result list (the second
    one carries the most confident text) and records its re-reads."""

    def __init__(self):
        self.reads, self.rereads = [], []

    def readtext(self, img):
        self.reads.append(img.shape)
        k = len(self.reads) - 1
        return RESULTS["confident"] if k == 1 else RESULTS["mixed"] if k == 3 else RESULTS["junk"]

    def reread_low_conf(self, img, results, conf_ths):
        self.rereads.append((np.array(img), [t for _, t, _ in results], conf_ths))
        return [(q, t.upper(), c) for q, t, c in results]


@pytest.mark.parametrize("ths", [0.0, 0.5], ids=["off", "on"])
def test_read_with_rotations_rereads_the_winner_as_jax(ths):
    """``reread_conf_ths > 0``: the winning rotation alone is re-read, in its
    own frame; 0 leaves it as read."""
    img = np.random.default_rng(1).integers(0, 256, (30, 50)).astype(np.uint8)
    ours, ref = _RotationEngine(), _RotationEngine()
    got, k = orient.read_with_rotations(ours, img, reread_conf_ths=ths)
    exp, exp_k = jax_orient.read_with_rotations(ref, img, reread_conf_ths=ths)
    assert k == exp_k == 1
    assert ours.reads == ref.reads
    assert [t for _, t, _ in got] == [t for _, t, _ in exp]
    assert len(ours.rereads) == len(ref.rereads) == (1 if ths else 0)
    for (a, ta, ca), (b, tb, cb) in zip(ours.rereads, ref.rereads):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (50, 30) and ta == tb and ca == cb


@pytest.fixture(scope="module")
def engines():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BB_OCR_COMPILE_CACHE", "0")  # no compilation cache under HOME
        jax_engine = JaxOCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, config=JaxEngineConfig(
            canvases=(JaxCanvasSpec(*CANVAS),), compute_dtype=jnp.float32, host_rectify=False,
            wire_bits=8, decoder="greedy", detect_pool=1, detect_coarse=0,
        ))
    port = OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, EngineConfig(
        canvases=(CanvasSpec(*CANVAS),), compute_dtype=torch.float32, host_rectify=False, decoder="greedy",
    ), device="cpu")
    return jax_engine, port


@pytest.fixture(scope="module")
def book1_half():
    """``book1.png`` halved, as the engine's uint8 gray input."""
    return _to_gray_u8(load_rgb(BOOK1)[::2, ::2])


@pytest.mark.parametrize("turn", [0, 1], ids=["upright", "quarter_turn"])
def test_read_with_rotations_matches_jax(engines, book1_half, turn):
    """Same k, equal texts, quads within 1 px, confidences within 1e-3
    (float32 both). At this canvas the cover reads few confident words, and
    a rotation other than 0 wins for the turned photo."""
    jax_engine, port = engines
    img = np.ascontiguousarray(np.rot90(book1_half, turn))
    ref, ref_k = jax_orient.read_with_rotations(jax_engine, img)
    got, k = orient.read_with_rotations(port, img)
    assert k == ref_k
    assert turn == 0 or k != 0
    assert len(ref) > 0 and len(got) == len(ref)
    for (q, t, c), (rq, rt, rc) in zip(got, ref):
        assert t == rt
        assert np.abs(np.asarray(q) - np.asarray(rq)).max() <= 1.0
        assert abs(c - rc) <= 1e-3


def test_extractor_auto_rotate_matches_jax(engines):
    """Both extractors with ``auto_rotate=True`` on the quarter-turned
    ``book1.png`` (halved), heuristic backend, no re-reads: the same
    metadata JSON, ``_processing_info`` aside."""
    jax_engine, port = engines
    rgb = np.ascontiguousarray(np.rot90(load_rgb(BOOK1)[::2, ::2], 1))
    knobs = dict(llm_backend="heuristic", auto_rotate=True, reread_low_conf=False, isbn_reread=False,
                 fast_single=False, warm_model=False)
    ref = JaxExtractor(engine=jax_engine, **knobs).extract_metadata_from_images([rgb], ocr_image_indices=[0])
    got = BookMetadataExtractor(engine=port, device="cpu", **knobs).extract_metadata_from_images([rgb], ocr_image_indices=[0])
    ref.pop("_processing_info")
    got.pop("_processing_info")
    assert got == ref


@pytest.mark.parametrize("argv,auto_rotate", [([], False), (["--auto-rotate"], True)], ids=["default_off", "flag"])
def test_cli_auto_rotate_flag(monkeypatch, tmp_path, argv, auto_rotate):
    """``--auto-rotate`` reaches the extractor; off by default, as in the JAX CLI."""
    from bbocr_tpu_torch.cli import process_book

    seen = {}
    monkeypatch.setattr(process_book, "process_book", lambda book_dir, extractor, **kw: seen.update(x=extractor))
    monkeypatch.setattr("sys.argv", ["process_book", "--book-dir", str(tmp_path), "--device", "cpu", *argv])
    process_book.main()
    assert seen["x"].auto_rotate is auto_rotate


def test_extractor_default_route_matches_jax():
    """Both extractors with their defaults (heuristic backend; float32
    engines on one canvas, otherwise in their default configuration: host
    rectification, greedy decode) on the quarter-turned cover: preprocessed
    to 1050x1312 it is camera-shaped, so both take the rotations, re-read
    the winner's low-confidence boxes from the full-resolution image with
    the device beam, and re-read ISBN suspects. The same metadata JSON,
    ``_processing_info`` aside."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BB_OCR_COMPILE_CACHE", "0")  # no compilation cache under HOME
        jax_engine = JaxOCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, config=JaxEngineConfig(
            canvases=(JaxCanvasSpec(*CANVAS),), compute_dtype=jnp.float32, host_rectify=True,
            wire_bits=8, decoder="greedy", detect_pool=1, detect_coarse=0,
        ))
    port = OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, EngineConfig(
        canvases=(CanvasSpec(*CANVAS),), compute_dtype=torch.float32, host_rectify=True, decoder="greedy",
    ), device="cpu")
    rgb = np.ascontiguousarray(np.rot90(load_rgb(BOOK1), 1))
    ref = JaxExtractor(llm_backend="heuristic", engine=jax_engine).extract_metadata_from_images([rgb], ocr_image_indices=[0])
    got = BookMetadataExtractor(llm_backend="heuristic", engine=port, device="cpu").extract_metadata_from_images(
        [rgb], ocr_image_indices=[0])
    ref.pop("_processing_info")
    got.pop("_processing_info")
    assert got == ref
