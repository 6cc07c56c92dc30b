"""The port's single-dispatch fast path against the JAX package's, on the CPU.

- ``decode/cc_device.py``: labels and top-K component stats equal to
  ``bbocr_tpu.decode.cc_device`` on seeded masks (blobs, a spiral that
  needs many propagation steps, one run stopped by a small ``max_iters``,
  an empty mask).
- ``runtime/fastpath.py::device_boxes_from_mask`` on the same masks.
- ``OCREngine.readtext_fast`` in float32 against the JAX engine's at one
  small canvas: equal texts, boxes within 1 px.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbocr_tpu.decode import cc_device as jax_cc
from bbocr_tpu.runtime import fastpath as jax_fastpath
from bbocr_tpu.runtime.bucketing import CanvasSpec as JaxCanvasSpec
from bbocr_tpu.runtime.engine import EngineConfig as JaxEngineConfig
from bbocr_tpu.runtime.engine import OCREngine as JaxOCREngine
from bbocr_tpu_torch.decode import cc_device
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
from bbocr_tpu_torch.runtime import fastpath
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec
from bbocr_tpu_torch.runtime.engine import _to_gray_u8

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRAFT_NPZ = os.path.join(ROOT, "checkpoints", "craft.npz")
CRNN_NPZ = os.path.join(ROOT, "checkpoints", "crnn.npz")
BOOK2 = os.path.join(ROOT, "data", "real", "covers", "book2.png")
CANVAS = (320, 256)


def _blobs(seed, shape, level):
    rng = np.random.default_rng(seed)
    noise = rng.normal(0, 1, shape)
    k = np.ones(5) / 5
    smooth = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, noise)
    smooth = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, smooth)
    return smooth > level


def _spiral(n):
    """Nested one-pixel-wide rings joined into one long winding component,
    whose labels need many propagation steps."""
    m = np.zeros((n, n), bool)
    top, left, bottom, right = 0, 0, n - 1, n - 1
    while top <= bottom and left <= right:
        m[top, left:right + 1] = True
        m[top:bottom + 1, right] = True
        if top + 2 <= bottom:
            m[bottom, left:right + 1] = True
        if left + 2 <= right and top + 4 <= bottom:
            m[top + 2:bottom + 1, left] = True
            m[top + 2, left:right - 1] = True
        top, left, bottom, right = top + 4, left + 2, bottom - 2, right - 2
    return m


MASKS = {
    "blobs": (_blobs(0, (48, 64), 0.25), 1024),
    "dense_blobs": (_blobs(1, (40, 56), -0.05), 1024),
    "spiral": (_spiral(33), 1024),
    "spiral_capped": (_spiral(33), 13),
    "empty": (np.zeros((16, 24), bool), 1024),
}


@pytest.mark.parametrize("name", sorted(MASKS))
def test_labels_match_jax(name):
    mask, max_iters = MASKS[name]
    ref = np.asarray(jax_cc.label_components_device(jnp.asarray(mask), max_iters=max_iters))
    got, steps = cc_device.label_components_device(torch.from_numpy(mask), max_iters=max_iters)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert steps <= max_iters
    if name == "spiral_capped":
        assert steps == max_iters
        # stopped before the fixed point: not one label per component
        full = np.asarray(jax_cc.label_components_device(jnp.asarray(mask)))
        assert not np.array_equal(ref, full)


@pytest.mark.parametrize("name", ["blobs", "dense_blobs", "spiral", "empty"])
def test_component_stats_match_jax(name):
    mask, _ = MASKS[name]
    score = np.random.default_rng(3).uniform(0, 1, mask.shape).astype(np.float32)
    labels = np.asarray(jax_cc.label_components_device(jnp.asarray(mask)))
    ref = [np.asarray(a) for a in jax_cc.component_stats_device(jnp.asarray(labels), 8, score=jnp.asarray(score))]
    got = [a.numpy() for a in cc_device.component_stats_device(torch.from_numpy(labels.copy()), 8, score=torch.from_numpy(score))]
    assert len(got) == len(ref) == 7
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("name", ["blobs", "dense_blobs", "spiral"])
def test_device_boxes_match_jax(name):
    mask, _ = MASKS[name]
    region = np.random.default_rng(4).uniform(0.3, 1.0, mask.shape).astype(np.float32)
    kw = dict(text_threshold=0.7, min_size_px=10)
    rb, rv = jax_fastpath.device_boxes_from_mask(jnp.asarray(mask), jnp.asarray(region), 12, **kw)
    gb, gv = fastpath.device_boxes_from_mask(torch.from_numpy(mask), torch.from_numpy(region), 12, **kw)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=0, atol=1e-5)


def test_readtext_fast_matches_jax_engine():
    """``book2.png`` (a small upright scan, the default route's fast-path
    case) at a 320x256 canvas, float32 both: the same boxes within 1 px and
    equal texts; confidences within 1e-3."""
    gray = _to_gray_u8(load_rgb(BOOK2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BB_OCR_COMPILE_CACHE", "0")  # no compilation cache under HOME
        jax_engine = JaxOCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, config=JaxEngineConfig(
            canvases=(JaxCanvasSpec(*CANVAS),), compute_dtype=jnp.float32, wire_bits=8, detect_pool=1,
            detect_coarse=0,
        ))
    port = OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, EngineConfig(
        canvases=(CanvasSpec(*CANVAS),), compute_dtype=torch.float32,
    ), device="cpu")
    ref = jax_engine.readtext_fast(gray)
    got = port.readtext_fast(gray)
    assert len(ref) > 0 and len(got) == len(ref)
    for (q, t, c), (rq, rt, rc) in zip(got, ref):
        assert t == rt
        assert np.abs(np.asarray(q) - np.asarray(rq)).max() <= 1.0
        assert abs(c - rc) <= 1e-3
    assert "fast" in port.timings()
