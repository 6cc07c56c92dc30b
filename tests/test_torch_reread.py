"""The port's full-resolution re-reads against the JAX engine's, in float32
on the CPU: ``lines_logits`` (host ROI crops, one batched warp and
recognition), ``reread_low_conf`` (device beam over the re-read logits)
and ``reread_isbn`` (digit-biased host beam), on ``book1.png``'s lines
and on a rendered ISBN line."""

import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbocr_tpu.runtime.bucketing import CanvasSpec as JaxCanvasSpec
from bbocr_tpu.runtime.engine import EngineConfig as JaxEngineConfig
from bbocr_tpu.runtime.engine import OCREngine as JaxOCREngine
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec
from bbocr_tpu_torch.runtime.engine import _to_gray_u8

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRAFT_NPZ = os.path.join(ROOT, "checkpoints", "craft.npz")
CRNN_NPZ = os.path.join(ROOT, "checkpoints", "crnn.npz")
BOOK1 = os.path.join(ROOT, "data", "real", "covers", "book1.png")
CANVAS = (256, 192)  # unused by the re-reads, which crop from the photo


@pytest.fixture(scope="module")
def engines():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BB_OCR_COMPILE_CACHE", "0")  # no compilation cache under HOME
        jax_engine = JaxOCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, config=JaxEngineConfig(
            canvases=(JaxCanvasSpec(*CANVAS),), compute_dtype=jnp.float32, wire_bits=8, detect_pool=1,
            detect_coarse=0,
        ))
    port = OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, EngineConfig(
        canvases=(CanvasSpec(*CANVAS),), compute_dtype=torch.float32,
    ), device="cpu")
    return jax_engine, port


@pytest.fixture(scope="module")
def cover():
    """``book1.png`` in gray at the preprocessed size (x1.5) as float32,
    and the quads of the JAX package's reading of it."""
    gray = _to_gray_u8(load_rgb(BOOK1))
    gray = cv2.resize(gray, (int(gray.shape[1] * 1.5), int(gray.shape[0] * 1.5)), interpolation=cv2.INTER_CUBIC)
    with open(os.path.join(ROOT, "tests", "data", "book1_jax_f32.json")) as f:
        ref = json.load(f)
    return gray.astype(np.float32), [np.asarray(q, np.float32) for q in ref["quads"]], ref["texts"]


@pytest.mark.parametrize("n", [1, 3, 5], ids=["one", "three", "five"])
def test_lines_logits_match_jax(engines, cover, n):
    """Logits within 1e-4 and equal frame counts, for batches that pad to
    1, 4 and 8 crops; the quads include one reaching past the photo."""
    jax_engine, port = engines
    image, quads, _ = cover
    quads = quads[:n - 1] + [quads[-1] + np.float32([[-30, -20], [40, -20], [40, 25], [-30, 25]])]
    ref_logits, ref_frames = jax_engine.lines_logits(image, quads)
    logits, frames = port.lines_logits(image, quads)
    np.testing.assert_array_equal(frames, ref_frames)
    assert logits.shape == ref_logits.shape and logits.dtype == np.float32
    np.testing.assert_allclose(logits, ref_logits, rtol=0, atol=1e-4)


def test_lines_logits_take_rgb_and_small_rois(engines, cover):
    """An RGB photo goes to gray in float32 as in the JAX engine, and a
    region larger than the 128x1024 canvas is scaled down."""
    jax_engine, port = engines
    image, quads, _ = cover
    rgb = np.stack([image, image[::-1], image[:, ::-1]], axis=-1)
    big = np.float32([[5, 5], [1500, 10], [1500, 200], [5, 190]])
    ref_logits, ref_frames = jax_engine.lines_logits(rgb, [quads[0], big])
    logits, frames = port.lines_logits(rgb, [quads[0], big])
    np.testing.assert_array_equal(frames, ref_frames)
    np.testing.assert_allclose(logits, ref_logits, rtol=0, atol=1e-4)


def test_reread_low_conf_matches_jax(engines, cover):
    """Results under 0.5 (the lowest eight of them) are re-read: the same
    texts and quads as the JAX engine's, confidences within 1e-4
    (relative)."""
    jax_engine, port = engines
    image, quads, texts = cover
    confs = [0.01, 0.3, 0.45, 0.9, 0.2, 0.05, 0.6, 0.1, 0.49, 0.15, 0.02]
    results = [(q, t if i != 4 else "", c) for i, (q, t, c) in enumerate(zip(quads, texts, confs))]
    ref = jax_engine.reread_low_conf(image, results, conf_ths=0.5)
    got = port.reread_low_conf(image, results, conf_ths=0.5)
    assert len(got) == len(ref) == len(results)
    assert [t for _, t, _ in got] == [t for _, t, _ in ref]
    assert sum(g[1] != r[1] for g, r in zip(got, results)) > 0  # some re-read won
    for (q, _, c), (rq, _, rc) in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(q), np.asarray(rq))
        assert c == pytest.approx(rc, rel=1e-4, abs=1e-12)


def _isbn_photo():
    """A rendered ISBN line on a light page, with its quad and a distractor."""
    page = np.full((260, 900), 235, np.uint8)
    cv2.putText(page, "ISBN 978-0-316-76948-8", (30, 120), cv2.FONT_HERSHEY_SIMPLEX, 1.6, 20, 3, cv2.LINE_AA)
    cv2.putText(page, "Little, Brown 1951", (30, 220), cv2.FONT_HERSHEY_SIMPLEX, 1.2, 40, 2, cv2.LINE_AA)
    isbn = np.float32([[20, 78], [740, 78], [740, 134], [20, 134]])
    other = np.float32([[20, 186], [470, 186], [470, 232], [20, 232]])
    return page.astype(np.float32), isbn, other


def test_reread_isbn_matches_jax(engines):
    jax_engine, port = engines
    photo, isbn_quad, other_quad = _isbn_photo()
    results = [(other_quad, "Little Brown 1951", 0.8), (isbn_quad, "ISBN 978O3I6769488", 0.3)]
    ref = jax_engine.reread_isbn(photo, results)
    got = port.reread_isbn(photo, results)
    assert got == ref
    assert port.reread_isbn(photo, results[:1]) is None  # no suspect, no re-read
