"""The port's host CLIs against their JAX counterparts.

``batch`` (serial with one shared extractor, and a pool of 2 workers) over
two books, ``smoke`` with ``--books-dir`` and rendering its own book,
``process_book --llm-backend ollama``
with a patched HTTP session, and ``compare_ocr`` on one photo: each writes
or prints what the JAX CLI does on the same input, timings aside. A
deterministic stub engine stands in for the shared CRAFT + CRNN engine of
both packages (so no CRAFT runs), and the session answers with a canned
reply. ``profile_engine --photos 1 --repeat 1`` runs the port's real engine
on one small float32 canvas and prints the JAX script's lines.
"""

import json
import os
import sys

import numpy as np
import pytest
import requests
import torch
from PIL import Image

from bbocr_tpu.cli import batch as jax_batch
from bbocr_tpu.cli import compare_ocr as jax_compare
from bbocr_tpu.cli import process_book as jax_process_book
from bbocr_tpu.cli import smoke as jax_smoke
from bbocr_tpu.extract import extractor as jax_extractor
from bbocr_tpu_torch.cli import batch, compare_ocr, process_book, profile_engine, smoke
from bbocr_tpu_torch.extract import extractor as port_extractor

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class StubEngine:
    """``readtext`` lines that depend on the pixels read."""

    def readtext(self, image):
        a = np.asarray(image, np.float64)
        s = int(a.sum()) % 9973
        w = a.shape[1]

        def quad(y):
            return np.array([[2, y], [w - 2, y], [w - 2, y + 30], [2, y + 30]], np.float32)

        return [(quad(10), f"THE RIVER {s}", 0.9), (quad(60), "by Maria Keller", 0.8),
                (quad(110), f"Copyright 19{s % 100:02d}", 0.6)]

    def read_joined(self, image):
        return " ".join(t for _, t, _ in self.readtext(image))

    def timings(self):
        return {}


class FakeResponse:
    def __init__(self, status_code, payload):
        self.status_code = status_code
        self._payload = payload
        self.text = ""

    def json(self):
        return self._payload


class FakeSession:
    def __init__(self):
        self.posts = []

    def post(self, url, json=None, headers=None, timeout=None):
        self.posts.append((url, json, headers, timeout))
        return FakeResponse(200, {"response": '```json\n{"title": "The Silent River", "year": "YYYY | null"}\n```'})


@pytest.fixture
def stub_engines(monkeypatch):
    engine = StubEngine()
    monkeypatch.setattr(jax_extractor, "_shared_engine", lambda *a: engine)
    monkeypatch.setattr(port_extractor, "_shared_engine", lambda *a: engine)
    return engine


def _books(tmp_path, ids=("1", "2")):
    """Copies of the books (the CLIs write next to nothing in them)."""
    root = tmp_path / "books"
    for b in ids:
        (root / b).mkdir(parents=True)
        for name in sorted(os.listdir(os.path.join(ROOT, "books", b))):
            if name.endswith(".jpg"):
                (root / b / name).write_bytes(open(os.path.join(ROOT, "books", b, name), "rb").read())
    return str(root)


def _saved(out_dir):
    """{file: JSON} of a CLI's output directory, timings and the port's
    box count aside."""
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            data = json.load(f)
        if "_processing_info" in data:
            data["_processing_info"].pop("engine_timings", None)
            data["_processing_info"].pop("ocr_boxes", None)
        for key in ("total_time_seconds", "average_time_per_book"):
            data.pop(key, None)
        out[name] = data
    return out


@pytest.mark.parametrize("workers", [1, 2])
def test_batch_matches_jax(workers, stub_engines, tmp_path, monkeypatch):
    books = _books(tmp_path)
    outs = {}
    for name, module in (("jax", jax_batch), ("port", batch)):
        out_dir = str(tmp_path / name)
        argv = ["batch", "--books-dir", books, "--output-dir", out_dir, "--max-workers", str(workers),
                "--llm-backend", "heuristic", "--no-preprocessing"]
        if module is batch:
            argv += ["--device", "cpu"]
        monkeypatch.setattr(sys, "argv", argv)
        module.main()
        outs[name] = _saved(out_dir)
    assert outs["port"] == outs["jax"]
    summary = outs["port"]["batch_processing_summary.json"]
    assert summary["succeeded"] == summary["total"] == 2 and summary["failed"] == 0
    assert outs["port"]["book_1_enhanced.json"]["authors"] == ["Maria Keller"]


def test_smoke_books_dir_matches_jax(stub_engines, tmp_path, monkeypatch, capsys):
    books = _books(tmp_path, ("1",))
    monkeypatch.setattr(sys, "argv", ["smoke", "--books-dir", books])
    assert jax_smoke.main() == 0
    ref = capsys.readouterr().out
    assert smoke.main(["--books-dir", books, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[-1] == ref.splitlines()[-1] == "SMOKE PASS"
    assert [ln for ln in got.splitlines() if not ln.startswith("book ")] == \
        [ln for ln in ref.splitlines() if not ln.startswith("book ")]
    # without --books-dir both render the same synthetic book (make_book,
    # seed 42; tests/test_torch_data_clis.py holds its bytes), whose
    # preprocessed pixels differ by the chain's known bicubic roundings: the
    # stub's texts carry a pixel sum, so the fields are compared, not values
    monkeypatch.setattr(sys, "argv", ["smoke"])
    assert jax_smoke.main() == 0
    ref = capsys.readouterr().out
    assert smoke.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[-1] == ref.splitlines()[-1] == "SMOKE PASS"
    assert [ln.split(":")[0] for ln in got.splitlines() if not ln.startswith(("book ", "rendered "))] == \
        [ln.split(":")[0] for ln in ref.splitlines() if not ln.startswith(("book ", "rendered "))]


def test_process_book_ollama_matches_jax(stub_engines, tmp_path, monkeypatch):
    """The default backend with its warm-up, through the session each CLI
    makes with ``requests.Session``."""
    books = _books(tmp_path, ("1",))
    sessions = []

    def make_session():
        sessions.append(FakeSession())
        return sessions[-1]

    monkeypatch.setattr(requests, "Session", make_session)
    monkeypatch.setattr("time.sleep", lambda s: None)
    for name, module in (("jax", jax_process_book), ("port", process_book)):
        argv = ["process_book", "--book-dir", os.path.join(books, "1"), "--output-dir", str(tmp_path / name),
                "--no-preprocessing"]
        if module is process_book:
            argv += ["--device", "cpu"]
        monkeypatch.setattr(sys, "argv", argv)
        module.main()
    assert len(sessions) == 2 and sessions[1].posts == sessions[0].posts
    assert [p[1]["prompt"] for p in sessions[1].posts][0] == "ping" and len(sessions[1].posts) == 2
    got, ref = _saved(str(tmp_path / "port")), _saved(str(tmp_path / "jax"))
    assert got == ref and got["book_1_enhanced.json"]["title"] == "The Silent River"


def test_process_book_pagereader_fails_naming_its_item(stub_engines, tmp_path, monkeypatch):
    """``--llm-backend tpu`` is ported and no longer fails: both CLIs read
    the book's first photo with their PageReader (each cached client's
    model a float32 one, set through ``client._model``) and save the same
    JSON."""
    import jax.numpy as jnp

    from bbocr_tpu.llm import native_vlm as jax_native
    from bbocr_tpu.models.vlm import PageReader as JaxPageReader
    from bbocr_tpu_torch.llm import native_vlm
    from bbocr_tpu_torch.models.vlm import PageReader

    books = _books(tmp_path, ("1",))
    monkeypatch.chdir(ROOT)  # both clients resolve checkpoints/vlm.npz from the working directory
    monkeypatch.delenv("BB_OCR_VLM_CKPT", raising=False)
    monkeypatch.setattr(jax_native, "_CLIENT_CACHE", {})
    monkeypatch.setattr(native_vlm, "_CLIENT_CACHE", {})
    jax_native.get_native_client()._model = JaxPageReader(dtype=jnp.float32)
    native_vlm.get_native_client(device="cpu")._model = PageReader(dtype=torch.float32)
    for name, module in (("jax", jax_process_book), ("port", process_book)):
        argv = ["process_book", "--book-dir", os.path.join(books, "1"), "--output-dir", str(tmp_path / name),
                "--no-preprocessing", "--llm-backend", "tpu", "--no-warm-model"]
        if module is process_book:
            argv += ["--device", "cpu"]
        monkeypatch.setattr(sys, "argv", argv)
        module.main()
    got, ref = _saved(str(tmp_path / "port")), _saved(str(tmp_path / "jax"))
    assert got == ref and got["book_1_enhanced.json"]["_processing_info"]["llm_backend"] == "tpu"


def test_compare_ocr_matches_jax(stub_engines, tmp_path, monkeypatch):
    """One photo (a crop of a book photo on which both chains agree), raw
    and preprocessed, through the stub engine; tesseract is absent."""
    monkeypatch.setitem(sys.modules, "pytesseract", None)
    photo = np.asarray(Image.open(os.path.join(ROOT, "books", "1", "IMG_0000.jpg")).convert("RGB"))
    path = tmp_path / "crop.png"
    Image.fromarray(np.ascontiguousarray(photo[150:214, 360:408])).save(path)
    reports = {}
    for name, module in (("jax", jax_compare), ("port", compare_ocr)):
        out_dir = tmp_path / name
        argv = ["compare_ocr", str(path), "--out", str(out_dir)]
        if module is compare_ocr:
            module.main(argv[1:] + ["--device", "cpu"])
        else:
            monkeypatch.setattr(sys, "argv", argv)
            module.main()
        with open(out_dir / "ocr_comparison_crop.json") as f:
            reports[name] = json.load(f)
        for key, row in reports[name].items():
            if isinstance(row, dict):
                row.pop("processing_time")
    assert reports["port"] == reports["jax"]
    assert sorted(reports["port"]) == ["image", "tpu_preprocessed", "tpu_raw"]


def test_profile_engine_prints_the_jax_lines(monkeypatch, capsys):
    from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
    from bbocr_tpu_torch.runtime.bucketing import CanvasSpec

    original = OCREngine.__dict__["from_checkpoint"]
    small = EngineConfig(canvases=(CanvasSpec(288, 224),), compute_dtype=torch.float32)
    monkeypatch.setattr(OCREngine, "from_checkpoint", classmethod(
        lambda cls, craft, crnn, *_, **kw: original.__func__(cls, craft, crnn, small, **kw)))
    profile_engine.main(["--photos", "1", "--repeat", "1", "--chunk", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "backend=cpu photos=1"
    head = json.loads(lines[1])
    assert sorted(head) == ["end_to_end_s_per_batch", "photos_per_sec", "stages"]
    assert {"letterbox", "detect", "boxes", "recognize"} <= set(head["stages"])
    ops = [json.loads(ln) for ln in lines[2:]]
    # the ops, and their keys, that bbocr_tpu/cli/profile_engine.py prints
    assert [o["op"] for o in ops] == ["host_letterbox", "upload_u8", "detect_resident", "detect_pipelined",
                                      "maps_download"]
    assert all(sorted(o) == ["canvas", "mean_ms", "min_ms", "op"] for o in ops if o["op"] != "detect_pipelined")
    assert ops[0]["canvas"] == "288x224x2"
