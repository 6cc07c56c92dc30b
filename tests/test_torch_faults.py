"""The port's engine maps its letterbox fills and host warps over the JAX
engine's 8-thread pool with results equal to the serial loops, and its extractor carries on
where the JAX extractor does when the OCR engine raises."""

import os

import numpy as np
import pytest
import torch

from bbocr_tpu.extract import BookMetadataExtractor as JaxExtractor
from bbocr_tpu_torch.extract import BookMetadataExtractor
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
from bbocr_tpu_torch.runtime import engine as port_engine
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRAFT_NPZ = os.path.join(ROOT, "checkpoints", "craft.npz")
CRNN_NPZ = os.path.join(ROOT, "checkpoints", "crnn.npz")
# mixed sizes: two covers (PNG), a 2400x1800 camera photo, a 600x800 page
PHOTOS = ("data/real/covers/book1.png", "data/real/covers/book4.png",
          "data/real/photos/3/IMG_9687.jpg", "books/1/IMG_0001.jpg")


@pytest.fixture(scope="module")
def photos():
    return [load_rgb(os.path.join(ROOT, rel)) for rel in PHOTOS]


@pytest.fixture(scope="module")
def engine():
    # two small canvases, so that both orientations share a canvas's chunk
    return OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, EngineConfig(
        canvases=(CanvasSpec(416, 320), CanvasSpec(320, 416)), compute_dtype=torch.float32,
        host_rectify=True, decoder="greedy", wire_bits=8, detect_coarse=0,
    ), device="cpu")


def _same(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for (qa, ta, ca), (qb, tb, cb) in zip(ra, rb):
            assert ta == tb and ca == cb
            np.testing.assert_array_equal(qa, qb)


def test_host_pool_equals_serial_loops(engine, photos, monkeypatch):
    """``readtext_batch`` and ``readtext_stream`` on four photos of mixed
    sizes: with the pool (the letterbox fills and the host warps each
    mapped over more than one task) the results equal the serial loops'
    bit for bit."""
    mapped = []
    pool_map = port_engine._host_map

    def counting(fn, tasks):
        mapped.append((fn.__name__, len(tasks)))
        pool_map(fn, tasks)

    monkeypatch.setattr(port_engine, "_host_map", counting)
    pooled = engine.readtext_batch(photos)
    streamed = list(engine.readtext_stream(iter([photos, photos[::-1]])))
    assert {name for name, n in mapped if n > 1} == {"fill", "warp"}
    assert sum(len(r) for r in pooled) > 0

    monkeypatch.setattr(port_engine, "_host_map", port_engine._serial_map)
    serial = engine.readtext_batch(photos)
    _same(pooled, serial)
    _same(streamed[0], serial)
    _same(streamed[1], serial[::-1])


def test_host_pool_is_one_pool_of_eight():
    pool = port_engine._letterbox_pool()
    assert pool is port_engine._letterbox_pool() and pool._max_workers == 8


class _Failing:
    """Fake engine whose ``readtext`` (and fast path), low-confidence
    re-read or ISBN re-read raises."""

    def __init__(self, fail):
        self.fail = fail

    def _read(self, image):
        if self.fail == "readtext":
            raise RuntimeError("device lost")
        return [(np.float32([[10, 10], [200, 10], [200, 40], [10, 40]]), "ISBN 978O3I6769488", 0.3),
                (np.float32([[10, 60], [150, 60], [150, 90], [10, 90]]), "The Catcher", 0.9),
                (np.float32([[10, 100], [150, 100], [150, 130], [10, 130]]), "Little Brown 1951", 0.8)]

    readtext = readtext_fast = _read

    def reread_low_conf(self, image, results, conf_ths):
        if self.fail == "reread":
            raise RuntimeError("re-read failed")
        return [(q, t.replace("O3I", "031"), c) for q, t, c in results]

    def reread_isbn(self, image, results):
        if self.fail == "isbn":
            raise RuntimeError("ISBN re-read failed")
        return "9780316769488"

    def timings(self):
        return {}


@pytest.mark.parametrize("fail", ["readtext", "reread", "isbn", None])
def test_ocr_failure_degrades_as_jax(fail, capsys):
    """Counterpart of ``tests/test_resilience.py::TestOCRFailureDegrades``:
    with an engine that raises in turn from ``readtext``,
    ``reread_low_conf`` and ``reread_isbn``, the port's extractor returns
    the JAX extractor's JSON (``_processing_info``'s counts included) and
    prints the same ``OCR failed`` lines."""
    images = [np.random.default_rng(i).integers(0, 255, (64, 48, 3)).astype(np.uint8) for i in range(3)]
    kw = dict(llm_backend="heuristic", use_preprocessing=False, warm_model=False)
    ref = JaxExtractor(engine=_Failing(fail), **kw).extract_metadata_from_images(images)
    jax_out = capsys.readouterr().out
    got = BookMetadataExtractor(engine=_Failing(fail), device="cpu", **kw).extract_metadata_from_images(images)
    assert capsys.readouterr().out == jax_out
    assert (jax_out.count("OCR failed: device lost") == 2) == (fail == "readtext")
    info, ref_info = got.pop("_processing_info"), ref.pop("_processing_info")
    assert got == ref
    for key in ("ocr_images_processed", "total_images", "structurer"):
        assert info[key] == ref_info[key]
    assert (info["ocr_images_processed"] == 0) == (fail == "readtext")
    assert (got["isbn_13"] is None) == (fail == "readtext")


@pytest.mark.parametrize("fail", ["readtext", None])
def test_chip_smoke_fails_on_a_swallowed_failure(fail, monkeypatch, capsys):
    """The extractor carries on from an OCR failure, as the JAX extractor
    does; ``chip_smoke.py`` records the exception it caught and fails the
    run at its next phase."""
    import chip_smoke

    for cls, name in ((BookMetadataExtractor, "_ocr_text"), (OCREngine, "reread_low_conf"),
                      (OCREngine, "reread_isbn")):
        monkeypatch.setattr(cls, name, getattr(cls, name))  # restored after the test
    monkeypatch.setattr(chip_smoke, "SWALLOWED", [])
    chip_smoke.watch_swallowed()
    image = np.random.default_rng(0).integers(0, 255, (64, 48, 3)).astype(np.uint8)
    meta = BookMetadataExtractor(engine=_Failing(fail), device="cpu", llm_backend="heuristic",
                                 use_preprocessing=False, warm_model=False).extract_metadata_from_images([image], [0])
    assert meta["_processing_info"]["ocr_images_processed"] == (0 if fail else 1)
    if fail:
        with pytest.raises(SystemExit):
            chip_smoke.phase("next")
        assert "1 exceptions were caught" in capsys.readouterr().err
    else:
        chip_smoke.phase("next")
