"""The port's evaluation CLIs against the JAX package's: the metric
functions, the offline structurer replay, the A/B table, the Pillow-free
gray loader, ``evaluate_real`` and ``evaluate_books`` on a few books at a
small canvas in float32, and the float-map ``extract_boxes``."""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from bbocr_tpu.cli import ab_summary as jax_ab
from bbocr_tpu.cli import evaluate as jax_eval
from bbocr_tpu.cli import evaluate_real as jax_real
from bbocr_tpu.cli import restructure as jax_restructure
from bbocr_tpu.decode.boxes import DetectionParams as JaxDetectionParams
from bbocr_tpu.decode.boxes import extract_boxes as jax_extract_boxes
from bbocr_tpu.utils import cer as jax_cer
from bbocr_tpu_torch.cli import ab_summary, evaluate, evaluate_real, restructure
from bbocr_tpu_torch.decode import DetectionParams, extract_boxes
from bbocr_tpu_torch.io import load_gray
from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec
from bbocr_tpu_torch.utils import cer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL = os.path.join(ROOT, "data", "real")
ARTIFACTS = [os.path.join(REAL, "eval_r2_final.json"), os.path.join(REAL, "eval_r2c2.json")]
DATA = os.path.join(ROOT, "tests", "data")
CANVAS = (416, 320)


def _ground_truth():
    with open(os.path.join(REAL, "ground_truth.json")) as f:
        return json.load(f)["books"]


def _pairs():
    """(ground-truth entry, recorded OCR text) of each book of both artifacts."""
    gt = _ground_truth()
    out = []
    for path in ARTIFACTS:
        with open(path) as f:
            for row in json.load(f)["details"]:
                out.append((gt[row["book"]], row["ocr_text"]))
    return out


def _random_strings(n=40, seed=0):
    rng = np.random.default_rng(seed)
    alphabet = list("abcXYZ 0129'-.é")
    return ["".join(rng.choice(alphabet, rng.integers(0, 24))) for _ in range(n)]


def test_metric_functions_match_jax():
    """``substring_cer``, ``phrase_cer``, ``word_recall`` (evaluate_real),
    ``_norm``, ``fuzzy_ratio``, ``score_fields`` (evaluate), ``levenshtein``,
    ``cer``, ``corpus_cer`` and ``wer`` equal JAX's on the recorded OCR
    text of the 42 books of two artifacts against their ground truth, and
    on seeded random strings."""
    pairs = _pairs()
    assert len(pairs) == 42
    for entry, text in pairs:
        phrases = entry.get("phrases", [])
        assert evaluate_real.word_recall(phrases, text) == jax_real.word_recall(phrases, text)
        assert evaluate_real.phrase_cer(phrases, text) == jax_real.phrase_cer(phrases, text)
        for p in phrases[:3]:
            assert evaluate_real.substring_cer(p, text) == jax_real.substring_cer(p, text)
        assert evaluate_real._words(text) == jax_real._words(text)
        pred = {f: (text.split() or [None])[0] for f in evaluate.FIELDS}
        assert evaluate.score_fields(entry, pred) == jax_eval.score_fields(entry, pred)
        for field in ("title", "authors", "year"):
            t, p = evaluate._norm(entry.get(field)), evaluate._norm(text[:40])
            assert t == jax_eval._norm(entry.get(field))
            assert evaluate.fuzzy_ratio(t, p) == jax_eval.fuzzy_ratio(t, p)
            assert cer.cer(t, p) == jax_cer.cer(t, p) and cer.wer(t, p) == jax_cer.wer(t, p)
    refs = [e.get("title") or "" for e, _ in pairs]
    hyps = [t[:60] for _, t in pairs]
    assert cer.corpus_cer(refs, hyps) == jax_cer.corpus_cer(refs, hyps)
    strings = _random_strings()
    for a, b in zip(strings, strings[1:] + strings[:1]):
        assert cer.levenshtein(a, b) == jax_cer.levenshtein(a, b)
        assert cer.cer(a, b) == jax_cer.cer(a, b) and cer.wer(a, b) == jax_cer.wer(a, b)
        assert evaluate_real.substring_cer(a, b) == jax_real.substring_cer(a, b)
        assert evaluate.fuzzy_ratio(a, b) == jax_eval.fuzzy_ratio(a, b)
        assert evaluate_real.word_recall([a], b) == jax_real.word_recall([a], b)
    assert cer.corpus_cer(strings, strings[::-1]) == jax_cer.corpus_cer(strings, strings[::-1])
    assert (evaluate.FIELDS, evaluate.FUZZY_THRESHOLD) == (jax_eval.FIELDS, jax_eval.FUZZY_THRESHOLD)
    assert evaluate_real.FIELDS == jax_real.FIELDS and restructure.FIELDS == jax_restructure.FIELDS
    assert evaluate_real.rotation_score is not None and evaluate_real.read_with_rotations is not None


@pytest.mark.parametrize("artifact", ARTIFACTS, ids=os.path.basename)
def test_restructure_replays_as_jax(artifact, tmp_path, monkeypatch, capsys):
    """``restructure`` over an artifact's saved lines: the same re-scored
    rows and the same printed table as JAX's."""
    monkeypatch.setattr(sys, "argv", ["restructure", "--eval", artifact, "--real-dir", REAL,
                                      "--verbose", "--out", str(tmp_path / "jax.json")])
    jax_restructure.main()
    jax_printed = capsys.readouterr().out
    restructure.main(["--eval", artifact, "--real-dir", REAL, "--verbose", "--out", str(tmp_path / "port.json")])
    printed = capsys.readouterr().out
    with open(tmp_path / "jax.json") as f, open(tmp_path / "port.json") as g:
        assert json.load(g) == json.load(f)
    assert printed.replace("port.json", "jax.json") == jax_printed


def test_ab_summary_rows_match_jax():
    paths = sorted(glob.glob(os.path.join(REAL, "eval_r2*.json")))
    assert len(paths) == 7
    for path in paths:
        assert ab_summary.row(path) == jax_ab.row(path)


def test_gray_loader_is_pillow_convert_l():
    """The 29 photos of ``data/real/`` in gray, bit for bit with Pillow's
    ``convert("L")`` (not cv2's RGB2GRAY)."""
    gt = _ground_truth()
    n = 0
    for key, entry in gt.items():
        for name in entry["images"]:
            path = os.path.join(REAL, *key.split("/"), name)
            if not os.path.isfile(path):
                path = os.path.join(REAL, os.path.dirname(key), name)
            got = load_gray(path)
            with Image.open(path) as img:
                want = np.asarray(img.convert("L"), np.float32)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=path)
            n += 1
    assert n == 29


def _close(a, b, tol=1e-3 + 1e-9):
    return abs(a - b) <= tol


def _small_float32_engines(monkeypatch):
    """``OCREngine.from_checkpoint`` builds float32 engines on one 416x320
    canvas, as the JAX references were recorded."""
    from_checkpoint = OCREngine.__dict__["from_checkpoint"]
    config = EngineConfig(canvases=(CanvasSpec(*CANVAS),), compute_dtype=torch.float32)
    monkeypatch.setattr(OCREngine, "from_checkpoint", classmethod(
        lambda cls, craft, crnn, *_, device, **__: from_checkpoint.__func__(cls, craft, crnn, config, device=device)))


def test_evaluate_real_matches_jax(monkeypatch):
    """``evaluate_real`` on a cover, a one-photo and a two-photo book at one
    416x320 canvas, float32: per book the rotations, texts, line texts,
    scores and fields equal the recorded JAX run's, confidences and line
    numbers within 1e-3; the corpus summary equal."""
    with open(os.path.join(DATA, "evaluate_real_jax_f32_416x320.json")) as f:
        ref = json.load(f)
    _small_float32_engines(monkeypatch)
    got = evaluate_real.evaluate_real(
        REAL, craft=os.path.join(ROOT, "checkpoints", "craft.npz"), crnn=os.path.join(ROOT, "checkpoints", "crnn.npz"),
        books_filter=[row["book"] for row in ref["details"]], device="cpu")
    assert [r["book"] for r in got["details"]] == [r["book"] for r in ref["details"]]
    for row, want in zip(got["details"], ref["details"]):
        for key in ("rotations", "tpu_word_recall", "tpu_phrase_cer", "tpu_text_chars", "fields", "ocr_text",
                    "images", "easyocr_word_recall", "easyocr_phrase_cer"):
            assert row.get(key) == want.get(key), (row["book"], key)
        assert [t for t, _ in row["results"]] == [t for t, _ in want["results"]]
        assert all(_close(c, rc) for (_, c), (_, rc) in zip(row["results"], want["results"]))
        assert [ln[0] for ln in row["lines"]] == [ln[0] for ln in want["lines"]]
        assert [ln[3] for ln in row["lines"]] == [ln[3] for ln in want["lines"]]
        assert all(_close(a, b) for ln, rl in zip(row["lines"], want["lines"]) for a, b in zip(ln[1:3], rl[1:3]))
    for key, value in ref.items():
        if key not in ("details", "dtype", "canvas"):
            assert got[key] == value, key


def test_evaluate_books_matches_jax(monkeypatch):
    """``evaluate_books`` on the first two books of ``books/`` through the
    no-engine extractor (preprocessing, the shared engine in
    ``BatchingOCR``, rotations), both shared engines on one 416x320 canvas
    in float32: each book's fields and the summary equal the recorded JAX
    run's."""
    from bbocr_tpu_torch.extract import extractor as extractor_module

    with open(os.path.join(DATA, "evaluate_books_jax_f32_416x320.json")) as f:
        ref = json.load(f)
    monkeypatch.setattr(extractor_module, "_ENGINE_CACHE", {})
    monkeypatch.delenv("BB_OCR_BATCHING", raising=False)
    _small_float32_engines(monkeypatch)
    try:
        got = evaluate.evaluate_books(os.path.join(ROOT, "books"), limit=2, device="cpu")
    finally:
        for engine in extractor_module._ENGINE_CACHE.values():
            engine.close()
    for row in got["details"]:
        row.pop("seconds")
    assert got["details"] == ref["details"]
    assert got["per_field"] == ref["per_field"] and got["mean_cer"] == ref["mean_cer"]


def test_evaluate_books_refuses_other_ocr_engines(monkeypatch, capsys):
    """``ocr_engine="tesseract"`` reaches the extractor's escape hatch, as in
    JAX; without ``pytesseract`` each OCR'd photo prints the hatch's error
    and adds no text, and no CRAFT + CRNN engine is built."""
    monkeypatch.setitem(sys.modules, "pytesseract", None)  # import raises ImportError
    got = evaluate.evaluate_books(os.path.join(ROOT, "books"), ocr_engine="tesseract", limit=1, device="cpu")
    out = capsys.readouterr().out
    assert out.count("OCR failed: tesseract escape hatch unavailable (pytesseract not installed)") == 2
    assert got["books"] == 1 and got["details"][0]["error"] is None


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extract_boxes_matches_jax(seed, use_native):
    """The float-map entry on seeded blob maps: the same quads as JAX's
    ``extract_boxes`` with its C++ or numpy labeling, within 1e-3 px."""
    rng = np.random.default_rng(seed)
    h, w = 96, 128
    yy, xx = np.mgrid[:h, :w]
    region = np.zeros((h, w), np.float32)
    for _ in range(8):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        sy, sx = rng.uniform(2, 6), rng.uniform(4, 20)
        region = np.maximum(region, rng.uniform(0.5, 1.0) * np.exp(-((yy - cy) / sy) ** 2 - ((xx - cx) / sx) ** 2))
    region = (region + rng.uniform(0, 0.05, (h, w))).astype(np.float32)
    affinity = (np.roll(region, 3, axis=1) * rng.uniform(0.3, 0.9)).astype(np.float32)
    got = extract_boxes(region, affinity, DetectionParams())
    want = jax_extract_boxes(region, affinity, JaxDetectionParams(use_native=use_native))
    assert len(want) > 0 and len(got) == len(want)
    for q, rq in zip(got, want):
        np.testing.assert_allclose(q, rq, atol=1e-3)
