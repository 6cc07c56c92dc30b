"""The port's extractor on its LLM route, with live traces, against the JAX
extractor.

One deterministic stub engine instance (``readtext`` and ``read_joined``
return lines that depend on the pixels they are given) is handed to both
extractors, and each backend gets a recording fake HTTP session, so no
model, network or CRAFT run is needed; ``time.sleep`` is patched out of
Ollama's back-off. For every backend, with and without preprocessing
(after asserting that both chains give equal arrays), these must be equal:
the requests posted (prompt, base64 JPEGs, headers, timeouts), the
returned metadata, ``_processing_info`` but ``engine_timings``, the trace's
``steps``, ``enhanced_prompt`` and ``ollama_raw``, the previews' pixels,
and the number of trace-sink calls. Also: Ollama's three attempts, a
garbage reply's all-null fallback, a schema violation's ``JSON validation
failed``, the debug-autocrop stub with a trace, the warm-up's warning, the
tesseract escape hatch with and without ``pytesseract``, and a heuristic
result the schema would refuse (none exists; see
``test_heuristics_never_break_the_schema``).
"""

import base64
import io
import json
import os
import sys
import types

import numpy as np
import pytest
import requests
import torch
from PIL import Image

from bbocr_tpu.extract.extractor import BookMetadataExtractor as JaxExtractor
from bbocr_tpu.extract.heuristics import heuristic_extract as jax_heuristic_extract
from bbocr_tpu.extract.heuristics import heuristic_extract_lines as jax_heuristic_lines
from bbocr_tpu.extract.schema import validate_schema as jax_validate_schema
from bbocr_tpu_torch.extract import heuristic_extract, heuristic_extract_lines, validate_schema
from bbocr_tpu_torch.extract.extractor import BookMetadataExtractor

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeResponse:
    def __init__(self, status_code, payload=None, text=""):
        self.status_code = status_code
        self._payload = payload or {}
        self.text = text

    def json(self):
        return self._payload


class FakeSession:
    """Answers every post with ``reply(url, json)`` and records it."""

    def __init__(self, reply):
        self.reply = reply
        self.posts = []

    def post(self, url, json=None, headers=None, timeout=None):
        self.posts.append((url, json, headers, timeout))
        out = self.reply(url, json)
        if isinstance(out, BaseException):
            raise out
        return out


ECHOED = (
    '```json\n{"title": "Stub Title", "subtitle": "string | null", "authors": ["Jane Author"], '
    '"publisher": null, "year": "YYYY | null", "isbn_10": "0306406152", "isbn_13": null, '
    '"categories": ["string", "..."] | [], "page_count": "integer | null", "price": {"currency": null, '
    '"amount": "float | null"}}\n```'
)


def backend_reply(backend, text=ECHOED):
    """A canned reply per backend: fenced JSON with echoed placeholders;
    Gemini answers 404 for the requested name, then 200 on the fallback."""

    def reply(url, payload):
        if backend == "ollama":
            if payload.get("prompt") == "ping":
                return FakeResponse(200, {"response": "pong"})
            return FakeResponse(200, {"response": text})
        if backend == "openai":
            return FakeResponse(200, {"choices": [{"message": {"content": text}}],
                                      "usage": {"prompt_tokens": 1500, "completion_tokens": 90}})
        if url.split("?")[0].endswith("models/gemini-1.5-flash:generateContent"):
            return FakeResponse(404, text="renamed")
        return FakeResponse(200, {"candidates": [{"content": {"parts": [{"text": text}]}}],
                                  "usageMetadata": {"promptTokenCount": 1400, "candidatesTokenCount": 70}})

    return reply


MODELS = {"ollama": "gemma3:4b", "openai": "gpt-4o", "gemini": "gemini-1.5-flash", "heuristic": "gemma3:4b"}


class StubEngine:
    """Lines whose text depends on the pixels read (so the two packages'
    OCR inputs must be equal for their prompts to be)."""

    def __init__(self, text_len=1):
        self.text_len = text_len

    def readtext(self, image):
        a = np.asarray(image, np.float64)
        s = int(a.sum()) % 9973
        w = a.shape[1]

        def quad(y):
            return np.array([[2, y], [w - 2, y], [w - 2, y + 9], [2, y + 9]], np.float32)

        return [(quad(4), f"THE STUB BOOK {s}" * self.text_len, 0.9), (quad(20), "by Jane Author", 0.8),
                (quad(36), f"Copyright 19{s % 100:02d}", 0.6), (quad(52), "ISBN 0-306-40615-2", 0.7)]

    def read_joined(self, image):
        return " ".join(t for _, t, _ in self.readtext(image))

    def timings(self):
        return {"stub": {"count": 1}}


# 64x48 crops of books/1 photos (photo, top, left) on which the JAX chain
# and the port's give equal arrays (elsewhere a few pixels of the bicubic
# resize may round apart, ROADMAP.md Queue 3); _equal_chains asserts it
CROPS = [(0, 150, 360), (1, 300, 240), (2, 350, 60), (2, 150, 180)]


def _images(n=3):
    from bbocr_tpu_torch.io import load_rgb

    photos = {}
    out = []
    for i, y, x in CROPS[:n]:
        photo = photos.setdefault(i, load_rgb(os.path.join(ROOT, "books", "1", f"IMG_000{i}.jpg")))
        out.append(np.ascontiguousarray(photo[y:y + 64, x:x + 48]))
    return out


@pytest.fixture(autouse=True)
def no_sleep_no_keys(monkeypatch):
    sleeps = []
    monkeypatch.setattr("time.sleep", lambda s: sleeps.append(s))
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
    monkeypatch.setenv("GEMINI_API_KEY", "g-test")
    monkeypatch.delenv("BB_OCR_DEBUG_AUTOCROP", raising=False)
    return sleeps


def _pixels(url):
    if url is None:
        return None
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(url.split(",", 1)[1]))))


def _run(cls, backend, engine, session, images, ocr_indices=None, capture_trace=True, **knobs):
    kw = dict(llm_backend=backend, model=MODELS[backend], engine=engine, warm_model=False, **knobs)
    if cls is BookMetadataExtractor:
        kw["device"] = "cpu"
    ext = cls(**kw)
    ext.session = session
    sink_calls = []
    try:
        meta = ext.extract_metadata_from_images(images, ocr_indices, capture_trace=capture_trace,
                                                trace_sink=sink_calls.append)
    except Exception as e:
        return {"raised": (type(e).__name__, str(e).splitlines()[0]), "posts": session.posts,
                "sinks": len(sink_calls)}
    return {"meta": meta, "posts": session.posts, "sinks": len(sink_calls), "sink_objects": sink_calls}


def _split(out):
    """-> (metadata without _processing_info and _trace, info without
    engine_timings, trace without previews, decoded previews)."""
    meta = dict(out["meta"])
    info = dict(meta.pop("_processing_info"))
    info.pop("engine_timings", None)
    trace = meta.pop("_trace", None)
    previews = []
    if trace is not None:
        trace = dict(trace)
        images = []
        for img in trace.pop("images"):
            img = dict(img)
            previews.append({k: _pixels(img.pop(k)) for k in sorted(img) if k.endswith("_b64")})
            images.append(img)
        trace["images"] = images
        steps = []
        for step in trace["steps"]:  # the steps' previews are the images' ones
            step = dict(step)
            if "images" in step:
                step["images"] = sorted(step["images"])
            steps.append(step)
        trace["steps"] = steps
    return meta, info, trace, previews


def _assert_same(got, ref):
    assert got["posts"] == ref["posts"]
    assert got["sinks"] == ref["sinks"]
    g_meta, g_info, g_trace, g_prev = _split(got)
    r_meta, r_info, r_trace, r_prev = _split(ref)
    assert g_meta == r_meta
    if g_info.get("structurer") == "heuristic":  # the port also counts the boxes read
        assert g_info.pop("ocr_boxes") >= 0
    assert g_info == r_info
    assert g_trace == r_trace
    assert len(g_prev) == len(r_prev)
    for g, r in zip(g_prev, r_prev):
        assert sorted(g) == sorted(r)
        for key in g:
            np.testing.assert_array_equal(g[key], r[key])


def _equal_chains(images):
    """Both packages' preprocessing gives equal arrays on these photos."""
    import jax.numpy as jnp

    from bbocr_tpu.preprocess import preprocess_for_book_cover as jax_pre
    from bbocr_tpu_torch.preprocess import preprocess_for_book_cover

    for rgb in images:
        ref = np.asarray(jax_pre(jnp.asarray(rgb, jnp.float32))[0])
        got = preprocess_for_book_cover(rgb, device="cpu")[0].numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("use_preprocessing", [False, True], ids=["raw", "preprocessed"])
@pytest.mark.parametrize("backend", ["ollama", "openai", "gemini", "heuristic"])
def test_route_and_trace_match_jax(backend, use_preprocessing):
    images = _images()
    if use_preprocessing:
        _equal_chains(images)
    engine = StubEngine()
    knobs = dict(use_preprocessing=use_preprocessing)
    ref = _run(JaxExtractor, backend, engine, FakeSession(backend_reply(backend)), images, **knobs)
    got = _run(BookMetadataExtractor, backend, engine, FakeSession(backend_reply(backend)), images, **knobs)
    _assert_same(got, ref)
    meta = got["meta"]
    steps = [s["step"] for s in meta["_trace"]["steps"]]
    assert steps[:2] == ["seed_images", "start_ocr"] and "build_prompt" in steps
    if backend == "heuristic":
        assert not got["posts"] and meta["_processing_info"]["structurer"] == "heuristic"
        return
    assert steps[-3:] == ["encode_images", "request_sent", "vlm_raw"]
    assert meta["title"] == "Stub Title" and meta["subtitle"] is None and meta["categories"] == []
    assert meta["_trace"]["ollama_raw"] == ECHOED
    assert len(got["posts"]) == (2 if backend == "gemini" else 1)
    assert ("llm_usage" in meta["_processing_info"]) == (backend != "ollama")
    # each sink call got its own shallow copy of the live trace
    assert all(s is not meta["_trace"] and s["steps"] is meta["_trace"]["steps"] for s in got["sink_objects"])


def test_preview_steps_and_skip_long_match_jax():
    """OCR of the second photo only, text over the per-image limit: the
    ``ocr_skip_long`` step, the third photo's ``preprocess_preview``, and
    the third photo's model input taken from its processed pixels."""
    images = _images(4)
    engine = StubEngine(text_len=3)
    knobs = dict(use_preprocessing=True, max_ocr_chars_per_image=40, edge_crop_percent=10.0)
    ref = _run(JaxExtractor, "ollama", engine, FakeSession(backend_reply("ollama")), images, [1], **knobs)
    got = _run(BookMetadataExtractor, "ollama", engine, FakeSession(backend_reply("ollama")), images, [1], **knobs)
    _assert_same(got, ref)
    steps = [s["step"] for s in got["meta"]["_trace"]["steps"]]
    assert "ocr_skip_long" in steps and steps.count("preprocess_preview") == 2
    assert steps.count("edge_crop_preview") == 2 and "edge_crop" in steps


def test_without_trace_matches_jax():
    images = _images()
    engine = StubEngine()
    ref = _run(JaxExtractor, "openai", engine, FakeSession(backend_reply("openai")), images, capture_trace=False,
               use_preprocessing=False)
    got = _run(BookMetadataExtractor, "openai", engine, FakeSession(backend_reply("openai")), images,
               capture_trace=False, use_preprocessing=False)
    _assert_same(got, ref)
    assert got["sinks"] == 0 and "_trace" not in got["meta"]


@pytest.mark.parametrize("case", ["ollama_down", "garbage", "schema_violation", "sink_raises"])
def test_failures_match_jax(case, no_sleep_no_keys):
    images = _images(2)
    engine = StubEngine()
    if case == "ollama_down":
        reply = lambda url, payload: requests.ConnectionError("connection refused")  # noqa: E731
    elif case == "garbage":
        reply = backend_reply("ollama", "I cannot read this book, sorry.")
    elif case == "schema_violation":
        reply = backend_reply("ollama", '{"title": 42, "authors": []}')
    else:
        reply = backend_reply("ollama")
    outs = []
    for cls in (JaxExtractor, BookMetadataExtractor):
        no_sleep_no_keys.clear()
        ext = cls(llm_backend="ollama", engine=engine, warm_model=False, use_preprocessing=False,
                  **({"device": "cpu"} if cls is BookMetadataExtractor else {}))
        ext.session = FakeSession(reply)
        if case == "sink_raises":
            ext.set_trace_sink(lambda trace: 1 / 0)
        try:
            out = ("ok", ext.extract_metadata_from_images(images, capture_trace=True))
        except Exception as e:
            out = ("raised", type(e).__name__, str(e).splitlines()[0])
        outs.append((out, list(no_sleep_no_keys), len(ext.session.posts)))
    (ref, ref_sleeps, ref_posts), (got, got_sleeps, got_posts) = outs
    assert (got_sleeps, got_posts) == (ref_sleeps, ref_posts)
    if case == "ollama_down":
        assert got == ref and got[2].startswith("Error from Ollama API: connection refused")
        assert got_posts == 3 and got_sleeps == [1.0, 2.0, 3.0]
    elif case == "schema_violation":
        assert got == ref and got[2] == "JSON validation failed: 42 is not of type 'string', 'null'"
    else:
        g_meta, g_info, g_trace, _ = _split({"meta": got[1]})
        r_meta, r_info, r_trace, _ = _split({"meta": ref[1]})
        assert (g_meta, g_info, g_trace) == (r_meta, r_info, r_trace)
        assert g_info.get("fallback_used", False) == (case == "garbage")


def test_debug_autocrop_stub_matches_jax(monkeypatch):
    monkeypatch.setenv("BB_OCR_DEBUG_AUTOCROP", "1")
    images = _images()
    engine = StubEngine()
    ref = _run(JaxExtractor, "ollama", engine, FakeSession(backend_reply("ollama")), images, crop_for_ocr=True,
               use_preprocessing=False)
    got = _run(BookMetadataExtractor, "ollama", engine, FakeSession(backend_reply("ollama")), images,
               crop_for_ocr=True, use_preprocessing=False)
    _assert_same(got, ref)
    assert got["meta"]["_processing_info"]["model_skipped"] and not got["posts"]
    assert [s["step"] for s in got["meta"]["_trace"]["steps"]][-1] == "ocr"


@pytest.mark.parametrize("status", [200, 500])
def test_warm_up_matches_jax(status, monkeypatch, capsys):
    """The warm-up ping at construction, through the session each package
    makes with ``requests.Session``; best effort on an error."""
    sessions = []

    def make_session():
        sessions.append(FakeSession(lambda url, payload: FakeResponse(status, {"response": "pong"})))
        return sessions[-1]

    monkeypatch.setattr(requests, "Session", make_session)
    JaxExtractor(engine=StubEngine())
    ref = capsys.readouterr().out
    BookMetadataExtractor(engine=StubEngine(), device="cpu")
    assert capsys.readouterr().out == ref
    assert sessions[0].posts == sessions[1].posts
    assert ref == ("Model warm-up request sent\n" if status == 200 else
                   "Warning: model warm-up skipped due to error: Warm-up status 500\n")
    assert sessions[1].trust_env is False


def test_session_is_made_on_first_use(monkeypatch, capsys):
    """Construction with a session passed in, or without a warm-up, makes
    none; the route without one raises naming ``requests`` where it is
    missing."""
    monkeypatch.setitem(sys.modules, "requests", None)
    ext = BookMetadataExtractor(engine=StubEngine(), device="cpu", warm_model=False, use_preprocessing=False)
    with pytest.raises(ImportError, match="requests"):
        ext.extract_metadata_from_images(_images(2))
    # the JAX defaults construct: the warm-up is best effort
    BookMetadataExtractor(device="cpu")
    assert capsys.readouterr().out.startswith("Warning: model warm-up skipped due to error: ")
    ext = BookMetadataExtractor(engine=StubEngine(), device="cpu", use_preprocessing=False,
                                session=FakeSession(backend_reply("ollama")))
    assert ext.extract_metadata_from_images(_images(2))["title"] == "Stub Title"


@pytest.fixture
def fake_pytesseract(monkeypatch):
    mod = types.ModuleType("pytesseract")
    calls = []

    def image_to_string(img):
        calls.append((img.mode, img.size))
        return "THE GREAT NOVEL\nby A. Writer\n\nCopyright 1987\nISBN 0-306-40615-2\n"

    mod.image_to_string = image_to_string
    mod._calls = calls
    monkeypatch.setitem(sys.modules, "pytesseract", mod)
    return mod


@pytest.mark.parametrize("installed", [True, False], ids=["fake_pytesseract", "missing"])
def test_tesseract_hatch_matches_jax(installed, request, monkeypatch, capsys):
    if installed:
        calls = request.getfixturevalue("fake_pytesseract")._calls
    else:
        monkeypatch.setitem(sys.modules, "pytesseract", None)
    image = np.full((100, 80), 240, np.uint8)
    outs = []
    for cls in (JaxExtractor, BookMetadataExtractor):
        ext = cls(ocr_engine="tesseract", llm_backend="heuristic", warm_model=False, use_preprocessing=False,
                  **({"device": "cpu"} if cls is BookMetadataExtractor else {}))
        meta = ext.extract_metadata_from_images([image], ocr_image_indices=[0])
        info = meta.pop("_processing_info")
        outs.append((meta, info["ocr_engine"], info["ocr_images_processed"], capsys.readouterr().out))
        assert ext._engine is None  # the CRAFT + CRNN engine is never built
    assert outs[1] == outs[0]
    if installed:
        assert outs[1][0]["isbn_10"] == "0306406152" and calls == [("RGB", (80, 100))] * 2
    else:
        assert outs[1][3] == "OCR failed: tesseract escape hatch unavailable (pytesseract not installed)\n"


WORDS = ["by", "Jane", "Author", "Press", "Published", "Copyright", "1987", "2003", "$12.99", "EUR", "9,50",
         "ISBN", "0-306-40615-2", "978-0-306-40615-7", "First", "Edition", "THE", "GREAT", "NOVEL", "Books",
         "House", "A.", "L.", "BURT", "COMPANY", "(c)", "©", "£5", "printed", "by", "Smith", "USD", "x", ""]


def test_heuristics_never_break_the_schema():
    """The heuristic branch's schema check: no OCR lines were found whose
    heuristic dict the schema refuses (each field is a string, a list of
    strings or the price's float), so the port keeps the check and returns
    what JAX returns. 150 random sets of lines of words the heuristics key on, with
    random confidences and heights, through both packages' structurers and
    both schema checkers."""
    rng = np.random.default_rng(0)
    for _ in range(150):
        lines = []
        for _ in range(rng.integers(0, 7)):
            text = " ".join(rng.choice(WORDS, rng.integers(1, 6)))
            lines.append((text, float(rng.random()), float(rng.random()) + 0.05, int(rng.integers(0, 3))))
        for meta, ref in ((heuristic_extract_lines(lines), jax_heuristic_lines(lines)),
                          (heuristic_extract("\n".join(t for t, *_ in lines)),
                           jax_heuristic_extract("\n".join(t for t, *_ in lines)))):
            assert meta == ref
            validate_schema(meta)
            jax_validate_schema(ref)
    assert json.dumps(meta)  # plain JSON types only
    # the extractor's heuristic branch and JAX's return the same dict
    images = _images(2)
    outs = [_run(cls, "heuristic", StubEngine(), FakeSession(backend_reply("heuristic")), images,
                 capture_trace=False, use_preprocessing=False)["meta"] for cls in (JaxExtractor, BookMetadataExtractor)]
    infos = [out.pop("_processing_info") for out in outs]
    for info in infos:
        info.pop("engine_timings")
    assert infos[1].pop("ocr_boxes") == 4  # the port's count of boxes read
    assert outs[1] == outs[0] and infos[1] == infos[0]
