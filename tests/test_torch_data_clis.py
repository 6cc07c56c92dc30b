"""The port's data CLIs and leftovers against the JAX package.

- ``harvest_real_crops``: the alignment helpers on random strings and
  phrases; ``harvest_image`` and the CLI (``--books``) against the live JAX
  ones on ``covers/book2`` at one small canvas in float32 with device
  warps; its ``labels.json`` read by ``cli/train.py::_load_real_val``;
- ``io.imread_gray`` against ``cv2.imread(path, IMREAD_GRAYSCALE)`` on
  every photo of ``data/real/`` (the JPEGs' luma plane, libpng's RGB-to-gray
  rule on the PNG covers), 0 pixels different, and its refusals;
- ``make_examples.make_book`` byte for byte against the JAX one;
- ``make_pipeline_crops.main`` on 2 small pages against the JAX ``main``;
- ``device_trace``, ``__version__`` and the ``utils`` re-export.

Both packages' engines are float32 on one canvas (``OCREngine.from_checkpoint``
patched where a CLI builds its own).
"""

import glob
import json
import os
import sys
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bbocr_tpu.cli import harvest_real_crops as jax_harvest
from bbocr_tpu.cli import make_examples as jax_examples
from bbocr_tpu.cli import make_pipeline_crops as jax_pipeline
from bbocr_tpu.runtime import engine as jax_engine_module
from bbocr_tpu.runtime.bucketing import CanvasSpec as JaxCanvasSpec
from bbocr_tpu_torch.cli import harvest_real_crops, make_examples, make_pipeline_crops
from bbocr_tpu_torch.io import UnsupportedPNG, encode_png, imread_gray, read_png
from bbocr_tpu_torch.runtime import engine as port_engine_module
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL = os.path.join(ROOT, "data", "real")
CRAFT, CRNN = (os.path.join(ROOT, "checkpoints", f"{m}.npz") for m in ("craft", "crnn"))
CANVAS = (416, 320)  # height, width: the portrait covers fit it
PHOTOS = sorted(os.path.relpath(p, REAL) for p in glob.glob(os.path.join(REAL, "photos", "*", "*.jpg"))
                + glob.glob(os.path.join(REAL, "covers", "*.png")))

WORDS = st.text(alphabet="ABCDEab c-'", min_size=0, max_size=10)


@settings(max_examples=200, deadline=None)
@given(WORDS, WORDS)
def test_lev_matches_jax(a, b):
    assert harvest_real_crops._lev(a, b) == jax_harvest._lev(a, b)
    assert harvest_real_crops._norm(a) == jax_harvest._norm(a)


@settings(max_examples=100, deadline=None)
@given(WORDS, st.lists(st.text(alphabet="ABCDE ab", min_size=0, max_size=16), max_size=4),
       st.floats(0.0, 1.0))
def test_best_span_matches_jax(text, phrases, max_cer):
    assert harvest_real_crops.best_span_with_margin(text, phrases) == jax_harvest.best_span_with_margin(text, phrases)
    assert harvest_real_crops.best_span_label(text, phrases, max_cer) == \
        jax_harvest.best_span_label(text, phrases, max_cer)


@pytest.mark.parametrize("rel", PHOTOS)
def test_imread_gray_is_cv2(rel):
    path = os.path.join(REAL, rel)
    got, want = imread_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert int((got != want).sum()) == 0


def _png(path, arr, color_type, depth=8):
    """A PNG of ``arr``'s raw samples with the given IHDR kind."""
    import struct

    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_imread_gray_refuses_other_png_kinds(tmp_path):
    rng = np.random.default_rng(0)
    gray = rng.integers(0, 256, (5, 7), np.uint8)
    (tmp_path / "gray.png").write_bytes(encode_png(gray))
    np.testing.assert_array_equal(imread_gray(str(tmp_path / "gray.png")), gray)
    np.testing.assert_array_equal(imread_gray(str(tmp_path / "gray.png")),
                                  cv2.imread(str(tmp_path / "gray.png"), cv2.IMREAD_GRAYSCALE))
    rgb = rng.integers(0, 256, (5, 7, 3), np.uint8)
    (tmp_path / "rgb.png").write_bytes(encode_png(rgb))
    np.testing.assert_array_equal(imread_gray(str(tmp_path / "rgb.png")),
                                  cv2.imread(str(tmp_path / "rgb.png"), cv2.IMREAD_GRAYSCALE))
    _png(str(tmp_path / "rgba.png"), rng.integers(0, 256, (5, 7, 4), np.uint8), 6)
    with pytest.raises(ValueError, match="RGBA"):
        imread_gray(str(tmp_path / "rgba.png"))
    _png(str(tmp_path / "palette.png"), gray, 3)
    with pytest.raises(UnsupportedPNG, match="color type 3"):
        imread_gray(str(tmp_path / "palette.png"))
    _png(str(tmp_path / "deep.png"), rng.integers(0, 256, (5, 14), np.uint8), 0, depth=16)
    with pytest.raises(UnsupportedPNG, match="bit depth 16"):
        imread_gray(str(tmp_path / "deep.png"))
    (tmp_path / "x.gif").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="PNG and baseline JPEG"):
        imread_gray(str(tmp_path / "x.gif"))


def _jax_engine(**knobs):
    from bbocr_tpu.runtime.engine import EngineConfig, OCREngine

    config = EngineConfig(canvases=(JaxCanvasSpec(*CANVAS),), compute_dtype=jnp.float32, **knobs)
    return OCREngine.from_checkpoint(CRAFT, CRNN, config)


def _port_engine(**knobs):
    from bbocr_tpu_torch.runtime import EngineConfig, OCREngine

    config = EngineConfig(canvases=(CanvasSpec(*CANVAS),), compute_dtype=torch.float32, **knobs)
    return OCREngine.from_checkpoint(CRAFT, CRNN, config, device="cpu")


@pytest.fixture(scope="module")
def engines():
    return _jax_engine(host_rectify=False), _port_engine(host_rectify=False)


def _hold_harvest(got_dir, got_labels, want_dir, want_labels):
    """Same names, labels, decodes and alignments, conf within 1e-3, crops
    of the same shape within 1 (a float32 warp within 1e-3 of JAX's,
    truncated to uint8)."""
    assert sorted(got_labels) == sorted(want_labels)
    for name, want in want_labels.items():
        got = got_labels[name]
        assert {k: got[k] for k in ("label", "decode", "align_cer", "align_margin")} == \
            {k: want[k] for k in ("label", "decode", "align_cer", "align_margin")}, name
        assert abs(got["conf"] - want["conf"]) <= 1e-3 + 1e-9, name
        crop, ref = read_png(os.path.join(got_dir, name)), cv2.imread(os.path.join(want_dir, name), cv2.IMREAD_GRAYSCALE)
        assert crop.shape == ref.shape, name
        assert np.abs(crop.astype(int) - ref).max() <= 1, name


def test_harvest_image_matches_jax(engines, tmp_path):
    jax_eng, port = engines
    with open(os.path.join(REAL, "ground_truth.json")) as f:
        phrases = [p for p in json.load(f)["books"]["covers/book2"]["phrases"] if p.strip()]
    image = imread_gray(os.path.join(REAL, "covers", "book2.png"))
    out = {}
    for name, module, engine in (("jax", jax_harvest, jax_eng), ("port", harvest_real_crops, port)):
        d = tmp_path / name
        d.mkdir()
        labels, stats = {}, {"crops_seen": 0, "crops_kept": 0}
        module.harvest_image(engine, image, phrases, "covers_book2_book2", str(d), labels, stats)
        out[name] = (str(d), labels, stats)
    assert out["port"][2] == out["jax"][2] and out["port"][2]["crops_kept"] > 0
    _hold_harvest(out["port"][0], out["port"][1], out["jax"][0], out["jax"][1])


@pytest.fixture
def small_engines(monkeypatch):
    """Both packages' ``OCREngine.from_checkpoint`` build float32 engines on
    the one small canvas (the CLIs' other knobs are their defaults)."""
    jax_original = jax_engine_module.OCREngine.__dict__["from_checkpoint"]
    port_original = port_engine_module.OCREngine.__dict__["from_checkpoint"]
    from bbocr_tpu.runtime.engine import EngineConfig as JaxConfig
    from bbocr_tpu_torch.runtime import EngineConfig

    monkeypatch.setattr(jax_engine_module.OCREngine, "from_checkpoint", classmethod(
        lambda cls, craft, crnn, *a, **kw: jax_original.__func__(
            cls, craft, crnn, JaxConfig(canvases=(JaxCanvasSpec(*CANVAS),), compute_dtype=jnp.float32))))
    monkeypatch.setattr(port_engine_module.OCREngine, "from_checkpoint", classmethod(
        lambda cls, craft, crnn, *a, device="cuda", **kw: port_original.__func__(
            cls, craft, crnn, EngineConfig(canvases=(CanvasSpec(*CANVAS),), compute_dtype=torch.float32),
            device=device)))


def test_harvest_cli_matches_jax_and_feeds_train(small_engines, tmp_path, monkeypatch, capsys):
    from bbocr_tpu_torch.cli.train import _load_real_val

    flags = ["--books", "covers/book2", "--data-dir", REAL, "--margin", "0.6,0.25"]
    monkeypatch.setattr(sys, "argv", ["harvest"] + flags + ["--out", str(tmp_path / "jax")])
    jax_harvest.main()
    want = capsys.readouterr().out.splitlines()[-1]
    harvest_real_crops.main(flags + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1] == want == json.dumps(json.loads(want))
    labels = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "labels.json") as f:
            labels[name] = json.load(f)
    _hold_harvest(str(tmp_path / "port"), labels["port"], str(tmp_path / "jax"), labels["jax"])
    crops, refs = _load_real_val(str(tmp_path / "port"), 256)
    assert refs == [labels["port"][n]["label"] for n in sorted(labels["port"])] and len(refs) > 0
    assert crops.shape[1:] == (32, 256)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_book_is_byte_equal_to_jax(seed, tmp_path):
    want = jax_examples.make_book(str(tmp_path / "jax"), seed, seed)
    got = make_examples.make_book(str(tmp_path / "port"), seed, seed)
    assert got == want
    book = str(seed + 1)
    names = sorted(os.listdir(tmp_path / "jax" / book))
    assert names == sorted(os.listdir(tmp_path / "port" / book)) and len(names) == 4
    for name in names:
        assert (tmp_path / "port" / book / name).read_bytes() == (tmp_path / "jax" / book / name).read_bytes(), name


def test_make_book_names_a_missing_font(tmp_path, monkeypatch):
    """Where a DejaVu font is missing, Pillow's ``OSError`` names no file;
    the port's is a ``FileNotFoundError`` naming it."""
    monkeypatch.setattr(jax_examples, "_FONTS_REG", str(tmp_path / "gone.ttf"))
    with pytest.raises(OSError):
        jax_examples.make_book(str(tmp_path / "jax"), 0, 0)
    monkeypatch.setattr(make_examples, "_FONTS_REG", str(tmp_path / "gone.ttf"))
    with pytest.raises(FileNotFoundError, match="gone.ttf"):
        make_examples.make_book(str(tmp_path / "port"), 0, 0)


def test_make_examples_main_prints_as_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["make_examples", "--out", str(tmp_path / "jax"), "--count", "2", "--seed", "5"])
    jax_examples.main()
    want = capsys.readouterr().out
    make_examples.main(["--out", str(tmp_path / "port"), "--count", "2", "--seed", "5"])
    assert capsys.readouterr().out == want
    assert sorted(os.listdir(tmp_path / "port")) == ["1", "2"]


def test_make_pipeline_crops_matches_jax(small_engines, tmp_path, monkeypatch, capsys):
    flags = ["--pages", "2", "--page-h", "416", "--page-w", "320", "--seed", "2"]
    monkeypatch.setattr(sys, "argv", ["make_pipeline_crops"] + flags + ["--out", str(tmp_path / "jax")])
    jax_pipeline.main()
    want = capsys.readouterr().out.splitlines()[-1]
    make_pipeline_crops.main(flags + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()[-1]
    assert got == want and json.loads(got)["pages"] == 2 and json.loads(got)["crops_kept"] > 0
    labels = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "labels.json") as f:
            labels[name] = json.load(f)
    _hold_harvest(str(tmp_path / "port"), labels["port"], str(tmp_path / "jax"), labels["jax"])


def test_device_trace_writes_only_when_configured(tmp_path, monkeypatch):
    from bbocr_tpu_torch.utils.profiling import device_trace

    monkeypatch.delenv("BB_OCR_PROFILE_DIR", raising=False)
    with device_trace():
        torch.ones(4).sum()
    assert not any(tmp_path.iterdir())
    with device_trace(str(tmp_path / "given")):
        torch.ones(4).sum()
    monkeypatch.setenv("BB_OCR_PROFILE_DIR", str(tmp_path / "env"))
    with device_trace():
        torch.ones(4).sum()
    for d in ("given", "env"):
        traces = os.listdir(tmp_path / d)
        assert len(traces) == 1 and traces[0].endswith(".json")
        with open(tmp_path / d / traces[0]) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name", "").startswith("aten::") for e in events)


def test_version_and_utils_reexport():
    import bbocr_tpu
    import bbocr_tpu.utils
    import bbocr_tpu_torch
    import bbocr_tpu_torch.utils
    from bbocr_tpu_torch.utils.env import env_flag

    assert bbocr_tpu_torch.__version__ == bbocr_tpu.__version__ == "0.1.0"
    assert bbocr_tpu_torch.__all__ == ["__version__"]
    assert bbocr_tpu_torch.utils.env_flag is env_flag and bbocr_tpu_torch.utils.__all__ == ["env_flag"]
    assert hasattr(bbocr_tpu.utils, "on_tpu") and not hasattr(bbocr_tpu_torch.utils, "on_tpu")
