"""The port's wire packing, coarse-quad merge and the engine's remaining
detect options against the JAX package's, on the CPU.

- ``quantize_dithered``, ``pack_canvas`` and ``unpack_widen``: bit-exact at
  1, 2, 4 and 8 bits.
- ``merge_coarse_quads``: the rules of ``tests/test_runtime.py`` and the
  JAX function's output on random quads, equal.
- The engine, float32, on one 416x320 canvas with each option
  (``wire_bits`` 4 and 2, ``detect_pool=2`` with the minimum area lowered
  to the canvas, ``detect_coarse=2``, ``fold_gray_stem=False``):
  ``readtext`` and ``readtext_fast`` against the JAX engine's readings
  recorded by ``scripts/torch_port_reference.py --engine-options --canvas
  416x320``, and ``wire_bits=4`` live against the JAX engine. Texts equal,
  quads within 1 px, confidences within 1e-3.

``EngineConfig()``'s new fields and environment variables are held to the
JAX one in ``tests/test_torch_engine.py::test_engine_config_defaults_match_jax``.
"""

import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbocr_tpu.decode.boxes import merge_coarse_quads as jax_merge_coarse_quads
from bbocr_tpu.runtime import wire as jax_wire
from bbocr_tpu.runtime.bucketing import CanvasSpec as JaxCanvasSpec
from bbocr_tpu.runtime.engine import EngineConfig as JaxEngineConfig
from bbocr_tpu.runtime.engine import OCREngine as JaxOCREngine
from bbocr_tpu_torch.decode import merge_coarse_quads
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
from bbocr_tpu_torch.runtime import wire
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRAFT_NPZ = os.path.join(ROOT, "checkpoints", "craft.npz")
CRNN_NPZ = os.path.join(ROOT, "checkpoints", "crnn.npz")
BOOK1 = os.path.join(ROOT, "data", "real", "covers", "book1.png")
OPTIONS_REFERENCE = os.path.join(ROOT, "tests", "data", "engine_options_jax_f32_416x320.json")


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(2, 37, 64), (1, 704, 512)], ids=["2x37x64", "1x704x512"])
def test_wire_packing_is_bit_exact_with_jax(bits, shape):
    rng = np.random.default_rng(bits)
    canvas = rng.integers(0, 256, shape).astype(np.uint8)
    canvas[0, 0, :4] = (0, 255, 0, 255)  # the ends of the range
    assert np.array_equal(wire.quantize_dithered(canvas, bits), jax_wire.quantize_dithered(canvas, bits))
    packed = wire.pack_canvas(canvas, bits)
    ref = jax_wire.pack_canvas(canvas, bits)
    assert packed.dtype == ref.dtype == np.uint8 and np.array_equal(packed, ref)
    got = wire.unpack_widen(torch.from_numpy(packed), bits)
    want = np.asarray(jax_wire.unpack_widen(jnp.asarray(ref), bits))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    if bits == 8:
        assert np.array_equal(got.numpy(), canvas)


def test_wire_rejects_other_depths():
    with pytest.raises(ValueError, match="wire_bits"):
        wire.pack_canvas(np.zeros((1, 4, 8), np.uint8), 3)
    with pytest.raises(ValueError, match="wire_bits"):
        wire.unpack_widen(torch.zeros((1, 4, 8), dtype=torch.uint8), 3)
    with pytest.raises(ValueError, match="wire_bits"):
        OCREngine({"params": {}}, {"params": {}}, EngineConfig(wire_bits=3), device="cpu")


def _rect(x0, y0, x1, y1):
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32)


def test_merge_coarse_quads_rules():
    """The cases of ``tests/test_runtime.py::test_merge_coarse_quads_rules``."""
    frags = [_rect(10, 10, 40, 120), _rect(60, 12, 90, 118), _rect(500, 10, 600, 40)]
    giant = [_rect(0, 0, 400, 130)]
    merged = merge_coarse_quads(frags, giant, giant_min_px=96.0)
    assert len(merged) == 2  # the far-away fine quad and the giant
    assert any((q == giant[0]).all() for q in merged)
    assert any((q == frags[2]).all() for q in merged)
    fine = [_rect(0, 0, 390, 125)]
    merged = merge_coarse_quads(fine, giant, giant_min_px=96.0)
    assert len(merged) == 1 and (merged[0] == fine[0]).all()
    assert merge_coarse_quads([], [_rect(0, 0, 50, 50)], giant_min_px=96.0) == []


@pytest.mark.parametrize("seed", range(4))
def test_merge_coarse_quads_matches_jax(seed):
    rng = np.random.default_rng(seed)

    def quads(n, lo, hi):
        out = []
        for _ in range(n):
            x0, y0 = rng.uniform(0, 600, 2)
            w, h = rng.uniform(lo, hi, 2)
            q = _rect(x0, y0, x0 + w, y0 + h)
            out.append(q + rng.normal(0, 2, q.shape).astype(np.float32))  # near-axis rotated
        return out

    fine, coarse = quads(12, 5, 120), quads(4, 60, 300)
    got = merge_coarse_quads(fine, coarse)
    want = jax_merge_coarse_quads(fine, coarse)
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.fixture(scope="module")
def options_reference():
    with open(OPTIONS_REFERENCE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small_cover():
    """``book1.png`` in gray, 320x400 (INTER_AREA), as the reference took it."""
    gray = cv2.cvtColor(load_rgb(BOOK1), cv2.COLOR_RGB2GRAY)
    return cv2.resize(gray, (320, 400), interpolation=cv2.INTER_AREA)


def _port_engine(config: dict):
    cfg = dict(config)
    cfg.pop("canvases", None)
    return OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, EngineConfig(
        canvases=(CanvasSpec(416, 320),), compute_dtype=torch.float32, **cfg), device="cpu")


def _assert_reading(got, ref):
    assert [t for _, t, _ in got] == ref["texts"]
    for (q, _, c), rq, rc in zip(got, ref["quads"], ref["confidences"]):
        assert np.abs(np.asarray(q) - np.asarray(rq)).max() <= 1.0
        assert abs(c - rc) <= 1e-3


OPTIONS = ["wire_bits=4", "wire_bits=2", "detect_pool=2", "detect_coarse=2", "fold_gray_stem=False"]


@pytest.mark.parametrize("option", OPTIONS)
def test_engine_option_matches_jax_reading(options_reference, small_cover, option):
    ref = options_reference["options"][option]
    assert options_reference["image_shape"] == list(small_cover.shape)
    engine = _port_engine(ref["config"])
    for fn in ("readtext", "readtext_fast"):
        _assert_reading(getattr(engine, fn)(small_cover), ref[fn])
    if option == "detect_pool=2":  # the pooled pass: half the maps, quads scaled by 2 * pool
        masks, _ = engine.detect(torch.zeros((1, 416, 320)), 2)
        assert tuple(masks.shape) == (1, 104, 80)


def test_engine_options_change_the_reading(options_reference):
    """The recorded readings differ from the default where the option
    changes the detector's input, so the comparisons above test it."""
    opts = options_reference["options"]
    default = opts["default"]["readtext"]["texts"]
    for option in ("wire_bits=4", "wire_bits=2", "detect_pool=2"):
        assert opts[option]["readtext"]["texts"] != default, option


def test_wire_bits_4_matches_the_live_jax_engine(small_cover):
    """The one live comparison: the JAX engine with ``wire_bits=4``."""
    knobs = dict(host_rectify=True, decoder="greedy", wire_bits=4, detect_coarse=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BB_OCR_COMPILE_CACHE", "0")
        jax_engine = JaxOCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, JaxEngineConfig(
            canvases=(JaxCanvasSpec(416, 320),), compute_dtype=jnp.float32, detect_pool=1, **knobs))
    port = _port_engine(knobs)
    for fn in ("readtext", "readtext_fast"):
        ref = getattr(jax_engine, fn)(small_cover)
        assert len(ref) > 0
        _assert_reading(getattr(port, fn)(small_cover), {
            "texts": [t for _, t, _ in ref], "quads": [q for q, _, _ in ref], "confidences": [c for _, _, c in ref]})
