"""The port runs where JAX, Pillow, OpenCV, jsonschema and requests are
missing, as on the machine with the card.

A subprocess blocks those imports with a ``sys.meta_path`` finder and
runs the port's extractor with the CLI's defaults on the CPU: a small PNG
(the fast path, then both re-reads, crops warped on the host by the C++
warp), and a JPEG of ``books/`` decoded by the port's decoder and read
through the rotation route (``auto_rotate`` left to resolve, then both
re-reads); then it imports ``chip_smoke`` without running its main. A
second subprocess runs this slice's paths the same way: the CLI's extractor
with no engine (the shared engine wrapped in ``BatchingOCR``) and the
auto-crop, the pipelined stream, ``warmup``, and an engine with bit-packed
canvases, the coarse pass and the unfolded stem. A third runs the
evaluation CLIs (``evaluate_real``, ``evaluate``, ``restructure``,
``ab_summary``) and engines of the lite and published detector layouts. A
fourth, with ``pytesseract`` blocked as well, runs the LLM route with a
session passed in (and without one, where it must raise naming
``requests``), the encoders, and the host CLIs ``process_book``, ``batch``
and ``smoke`` over ``books/``, ``compare_ocr`` and ``profile_engine``. A
fifth serves the scanner service on the CPU (``httpx``, ``bs4``,
``gspread`` and ``google`` are blocked in all of them): its warm-up, jobs on
``books/1`` (heuristic and ollama through a session passed in), the review
and pricing requests and the pricing CLI through canned HTTP clients;
without a session and without ``httpx`` it answers as the JAX service does
without ``requests`` and ``httpx``. A sixth runs the PageReader: the
extractor's ``tpu`` route without a session (the client reads the shipped
checkpoint the service names, in bfloat16) and ``vlm_eval --real`` on one
cover. A seventh, with ``optax`` and ``orbax`` blocked too, imports every
module of the port, checks that the synthetic generators, the training
CLI's synthetic source and ``vlm_eval --synthetic`` raise naming Pillow,
and runs the training CLI's recognizer loop on a recorded batch (save,
resume, serve the checkpoint) and ``OCREngine.create()``. An eighth imports
the data CLIs and ``parallel/``, checks that the book and page renderers
raise naming Pillow, and harvests a cover without OpenCV. A last test reads
the port's sources: none imports JAX, flax, optax, orbax or ``bbocr_tpu``.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKER = textwrap.dedent(
    """
    import importlib.abc
    import json
    import sys

    BLOCKED = {"jax", "jaxlib", "flax", "bbocr_tpu", "PIL", "cv2", "jsonschema", "requests", "pytesseract", "httpx",
               "bs4", "gspread", "google"}

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Blocker())
    for name in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:  # namespace packages a .pth file loaded
        del sys.modules[name]
    try:
        import cv2  # noqa: F401
    except ImportError:
        pass
    else:
        raise SystemExit("the import blocker does not work")
    """
)

SCRIPT = BLOCKER + textwrap.dedent(
    """
    import torch

    torch.set_num_threads(2)
    from bbocr_tpu_torch.cli.process_book import make_extractor
    from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
    from bbocr_tpu_torch.runtime.bucketing import CanvasSpec

    extractor = make_extractor(device="cpu", auto_rotate=None)
    engine = extractor._engine = OCREngine.from_checkpoint(
        "checkpoints/craft.npz", "checkpoints/crnn.npz",
        EngineConfig(canvases=(CanvasSpec(288, 224),), compute_dtype=torch.float32),
        device="cpu",
    )
    calls = []
    for name in ("readtext", "readtext_fast", "reread_low_conf", "reread_isbn"):
        def counted(*args, _fn=getattr(engine, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        setattr(engine, name, counted)
    meta = extractor.extract_metadata_from_images([sys.argv[1]], ocr_image_indices=[0])
    small_route, calls[:] = list(calls), []

    from bbocr_tpu_torch.io import load_rgb

    photo = load_rgb("books/1/IMG_0000.jpg")
    camera = extractor.extract_metadata_from_images([photo], ocr_image_indices=[0])
    import chip_smoke  # noqa: F401  (imported, main not run)

    loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
    print(json.dumps({"meta": meta, "camera": camera, "loaded": loaded, "photo": list(photo.shape),
                      "small_route": small_route, "camera_route": calls, "host_rectify": engine.config.host_rectify}))
    """
)


SLICE_SCRIPT = BLOCKER + textwrap.dedent(
    """
    import numpy as np
    import torch

    torch.set_num_threads(2)
    from bbocr_tpu_torch.cli.process_book import make_extractor
    from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
    from bbocr_tpu_torch.runtime.bucketing import CanvasSpec

    SMALL = dict(canvases=(CanvasSpec(288, 224),), compute_dtype=torch.float32)
    built, calls = [], []
    from_checkpoint = OCREngine.from_checkpoint.__func__

    def small_engine(cls, craft, crnn, config=None, **kw):  # the shared engine, at a small size
        engine = from_checkpoint(cls, craft, crnn, EngineConfig(**SMALL), **kw)
        batch = engine.readtext_batch
        engine.readtext_batch = lambda images: calls.append(len(images)) or batch(images)
        built.append(engine)
        return engine

    OCREngine.from_checkpoint = classmethod(small_engine)
    extractor = make_extractor(device="cpu", crop_for_ocr=True)
    meta = extractor.extract_metadata_from_images([sys.argv[1]], ocr_image_indices=[0])
    OCREngine.from_checkpoint = classmethod(from_checkpoint)
    engine = built[0]
    image = np.asarray(extractor._process_image(np.zeros((200, 160, 3), np.uint8) + 128)["final"])
    small = meta["_processing_info"]
    batches = [[image], [], [image, image[::-1].copy()]]
    stream = list(engine.readtext_stream(iter(batches)))
    same = [engine.readtext_batch(b) for b in batches] == stream
    warm = engine.warmup()
    options = OCREngine.from_checkpoint(
        "checkpoints/craft.npz", "checkpoints/crnn.npz",
        EngineConfig(wire_bits=4, detect_coarse=2, detect_pool=2, detect_pool_min_area=0, fold_gray_stem=False,
                     **SMALL), device="cpu")
    options.readtext(image)
    options.readtext_fast(image)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
    print(json.dumps({"wrapper": type(extractor.engine).__name__, "calls": calls[:1], "engines": len(built),
                      "stream_equal": same, "stream_len": len(stream), "warmup": warm, "loaded": loaded,
                      "title": "title" in meta}))
    """
)


EVAL_SCRIPT = BLOCKER + textwrap.dedent(
    """
    import contextlib
    import io

    import numpy as np
    import torch

    torch.set_num_threads(2)
    from bbocr_tpu_torch.cli import ab_summary, evaluate, evaluate_real, restructure
    from bbocr_tpu_torch.runtime import EngineConfig, OCREngine, bucketing
    from bbocr_tpu_torch.utils.checkpoint import load_params
    from chip_smoke import seeded_variables

    bucketing.DEFAULT_CANVASES = (bucketing.CanvasSpec(288, 224),)
    out_path = sys.argv[1]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        evaluate_real.main(["--books", "covers/book2", "--device", "cpu", "--out", out_path])
        from_checkpoint = OCREngine.from_checkpoint.__func__
        OCREngine.from_checkpoint = classmethod(lambda cls, craft, crnn, *_, **kw: from_checkpoint(
            cls, craft, crnn, EngineConfig(compute_dtype=torch.float32), **kw))
        rc = evaluate.main(["--books-dir", "books", "--limit", "1", "--device", "cpu"])
        OCREngine.from_checkpoint = classmethod(from_checkpoint)
        restructure.main(["--eval", out_path])
        ab_summary.main([out_path, "data/real/eval_r2_final.json"])
    with open(out_path) as f:
        real = json.load(f)
    shapes = json.load(open("tests/data/layouts_jax_shapes.json"))
    crnn = load_params("checkpoints/crnn.npz")
    detectors = []
    for craft in (load_params("checkpoints/candidates/craft_lite_raw.npz"),
                  seeded_variables(shapes["published"], shapes["seed"])):
        engine = OCREngine(craft, crnn, EngineConfig(compute_dtype=torch.float32), device="cpu")
        engine.readtext(np.full((200, 160), 128, np.uint8))
        detectors.append(type(engine.craft).__name__)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
    print(json.dumps({"books": real["books"], "rotations": real["details"][0]["rotations"], "rc": rc,
                      "printed": printed.getvalue(), "detectors": detectors, "loaded": loaded}))
    """
)


LLM_SCRIPT = BLOCKER + textwrap.dedent(
    """
    import contextlib
    import io
    import os

    import numpy as np
    import torch

    torch.set_num_threads(2)
    from bbocr_tpu_torch.cli import batch, compare_ocr, process_book, profile_engine, smoke
    from bbocr_tpu_torch.extract import BookMetadataExtractor
    from bbocr_tpu_torch.io import encode_jpeg, encode_png, load_rgb, pil_thumbnail_u8
    from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
    from bbocr_tpu_torch.runtime.bucketing import CanvasSpec

    SMALL = EngineConfig(canvases=(CanvasSpec(288, 224),), compute_dtype=torch.float32)
    from_checkpoint = OCREngine.from_checkpoint.__func__
    OCREngine.from_checkpoint = classmethod(lambda cls, craft, crnn, *_, **kw: from_checkpoint(
        cls, craft, crnn, SMALL, **kw))

    class Reply:
        status_code, text = 200, ""

        def json(self):
            return {"response": '```json\\n{"title": "T", "year": "YYYY | null"}\\n```'}

    class Session:
        posts = []

        def post(self, url, json=None, headers=None, timeout=None):
            self.posts.append(url)
            return Reply()

    tmp = sys.argv[1]
    photos = [np.ascontiguousarray(load_rgb(f"books/1/IMG_000{i}.jpg")[:256, :192]) for i in range(3)]
    session = Session()
    ext = BookMetadataExtractor(device="cpu", session=session)
    meta = ext.extract_metadata_from_images(photos, capture_trace=True)
    try:
        BookMetadataExtractor(device="cpu", warm_model=False).extract_metadata_from_images(photos[:1])
        no_session = "returned"
    except ImportError as e:
        no_session = str(e)
    photo = load_rgb("books/1/IMG_0001.jpg")
    thumb = pil_thumbnail_u8(photo, 300)
    sizes = [len(encode_jpeg(thumb, 88)), len(encode_png(thumb))]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        process_book.main(["1", "--books-dir", "books", "--llm-backend", "heuristic", "--device", "cpu",
                           "--output-dir", os.path.join(tmp, "pb")])
        summary = batch.main(["--books-dir", "books", "--book-ids", "1", "2", "--max-workers", "2",
                              "--llm-backend", "heuristic", "--device", "cpu",
                              "--output-dir", os.path.join(tmp, "batch")])
        rc = smoke.main(["--books-dir", "books", "--device", "cpu"])
        compare_ocr.main(["books/1/IMG_0002.jpg", "--device", "cpu", "--no-preprocess"])
        profile_engine.main(["--photos", "1", "--repeat", "1", "--chunk", "1", "--device", "cpu"])
    loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
    print(json.dumps({"title": meta["title"], "steps": [s["step"] for s in meta["_trace"]["steps"]],
                      "posts": len(session.posts), "no_session": no_session, "thumb": list(thumb.shape),
                      "sizes": sizes, "batch_ok": summary["succeeded"], "smoke_rc": rc,
                      "printed": printed.getvalue(), "loaded": loaded}))
    """
)


SERVICE_SCRIPT = BLOCKER + textwrap.dedent(
    """
    import contextlib
    import io
    import os

    import torch

    torch.set_num_threads(2)
    from bbocr_tpu_torch.cli import pricing as pricing_cli
    from bbocr_tpu_torch.pricing.providers import abebooks_html, google_books
    from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
    from bbocr_tpu_torch.runtime.bucketing import CanvasSpec
    from bbocr_tpu_torch.server.app import ScannerService
    from scripts.torch_port_reference import (LLM_MODELS, LLM_REPLIES, CannedHttp, CannedSession, ServiceThread,
                                              http_json, pricing_flow, server_jobs, wait_jobs_idle)

    SMALL = EngineConfig(canvases=(CanvasSpec(288, 224),), compute_dtype=torch.float32)
    from_checkpoint = OCREngine.from_checkpoint.__func__
    OCREngine.from_checkpoint = classmethod(lambda cls, craft, crnn, *_, **kw: from_checkpoint(
        cls, craft, crnn, SMALL, **kw))
    warmups, warmup = [], OCREngine.warmup
    OCREngine.warmup = lambda self, *a: warmups.append(warmup(self, *a)) or warmups[-1]
    os.environ["BB_OCR_ENGINE_WARMUP"] = "1"
    with open("tests/data/pricing_jax.json") as f:
        pref = json.load(f)
    clients = google_books._async_client, abebooks_html._async_client
    google_books._async_client = abebooks_html._async_client = CannedHttp(
        pref["google_payload"], {kn: pref["pages"][name] for kn, name in pref["lookup_pages"].items()})
    tmp = sys.argv[1]
    session = CannedSession(LLM_REPLIES, LLM_MODELS["gemini"])
    service = ScannerService(data_dir=tmp, device="cpu", session=session)
    with ServiceThread(service) as srv:
        _, health = http_json(srv.base, "GET", "/api/health")
        records, jobs = server_jobs(srv.base, session, ["1"])
        idle = wait_jobs_idle(service)
        flow = pricing_flow(srv.base, pref["accepted"], tmp)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            pricing_cli.main(["--from-json", os.path.join(service.accepted_dir, "book_1_ollama.json"), "--select"])
    google_books._async_client, abebooks_html._async_client = clients
    os.environ.pop("BB_OCR_ENGINE_WARMUP")
    bare = ScannerService(data_dir=os.path.join(tmp, "bare"), device="cpu")
    with ServiceThread(bare) as srv, contextlib.redirect_stderr(io.StringIO()):
        bare_models = http_json(srv.base, "GET", "/api/models")[0]
        _, bare_lookup = http_json(srv.base, "POST", "/api/pricing_lookup", {"title": "T", "authors": ["A"]})
    loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
    print(json.dumps({"loaded": loaded, "health": health, "warmups": warmups, "idle": idle,
                      "statuses": {b: jobs[b]["1"]["statuses"] for b in jobs},
                      "titles": {b: records[b]["1"]["meta"]["title"] for b in records},
                      "flow_equal": flow == pref["service"], "cli_equal": json.loads(printed.getvalue()) == pref["cli"],
                      "bare_models": bare_models, "bare_errors": bare_lookup["errors"]}))
    """
)

VLM_SCRIPT = BLOCKER + textwrap.dedent(
    """
    import os
    import shutil
    import sys

    import torch

    torch.set_num_threads(2)
    from bbocr_tpu_torch.cli import vlm_eval
    from bbocr_tpu_torch.extract import BookMetadataExtractor
    from bbocr_tpu_torch.llm import NativeVLMClient, create_llm_client

    tmp = sys.argv[1]
    ext = BookMetadataExtractor(llm_backend="tpu", model="checkpoints/vlm.npz", device="cpu")
    meta = ext.extract_metadata_from_images(["books/1/IMG_0000.jpg"], ocr_image_indices=[])
    client = create_llm_client("tpu", device="cpu")
    os.makedirs(os.path.join(tmp, "covers"))
    shutil.copy("data/real/covers/book2.png", os.path.join(tmp, "covers"))
    with open(os.path.join(tmp, "ground_truth.json"), "w") as f:
        json.dump({"books": {"covers/book2": {"title": "1984", "authors": ["George Orwell"]}}}, f)
    report = vlm_eval.main(["--real", "--real-dir", tmp, "--device", "cpu"])
    loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
    print(json.dumps({"loaded": loaded, "meta": meta, "client": type(client).__name__,
                      "dtype": str(client._model.dtype), "path": client._loaded[0], "real": report["real"]}))
    """
)


TRAIN_BLOCKER = BLOCKER.replace('"google"}', '"google", "optax", "orbax"}')
assert TRAIN_BLOCKER != BLOCKER

TRAIN_SCRIPT = TRAIN_BLOCKER + textwrap.dedent(
    """
    import importlib
    import os
    import pkgutil
    import sys

    import numpy as np
    import torch

    torch.set_num_threads(2)
    import bbocr_tpu_torch

    imported = []
    for info in pkgutil.walk_packages(bbocr_tpu_torch.__path__, "bbocr_tpu_torch."):
        if not info.name.endswith("__main__"):
            importlib.import_module(info.name)
            imported.append(info.name)
    from bbocr_tpu_torch.cli import train, vlm_eval
    from bbocr_tpu_torch.models.charset import EN_CHARSET
    from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
    from bbocr_tpu_torch.runtime.bucketing import CanvasSpec
    from bbocr_tpu_torch.train import photo_aug, synth

    refusals = {}
    for name, call in (
        ("lines", lambda: synth.TextLineGenerator(synth.SynthConfig(), seed=0).batch(1, width=64)),
        ("pages", lambda: synth.PageGenerator(synth.SynthConfig(), seed=0).batch(1, 64, 64)),
        ("labeled", lambda: synth.PageGenerator(synth.SynthConfig(), seed=0).batch_labeled(1, 64, 64)),
        ("blur", lambda: photo_aug.gaussian_blur(__import__("random").Random(0), np.zeros((8, 8)))),
        ("cli", lambda: train.train_crnn(train.build_parser().parse_args(
            ["--component", "crnn", "--steps", "1", "--device", "cpu", "--data-threads", "1"]))),
        ("vlm_eval", lambda: vlm_eval.eval_synthetic(None, 1, 1, 64, 48)),
    ):
        try:
            call()
            refusals[name] = None
        except ImportError as e:
            refusals[name] = str(e)

    tmp = sys.argv[1]
    with np.load("tests/data/train_batches.npz") as data:
        batch = tuple(data[k][:4] for k in ("crnn_crops", "crnn_labels", "crnn_label_lens", "crnn_frame_lens"))
    refs = [EN_CHARSET.decode_ids(batch[1][i][: batch[2][i]]) for i in range(2)]
    flags = ["--component", "crnn", "--batch", "4", "--out", tmp, "--state-dir", os.path.join(tmp, "state"),
             "--save-every", "1", "--log-every", "1", "--device", "cpu", "--init-from", "checkpoints/crnn.npz"]
    first = train.train_crnn(train.build_parser().parse_args(flags + ["--steps", "1"]),
                             source=train.Batches([batch]), val=(batch[0][:2], refs))
    second = train.train_crnn(train.build_parser().parse_args(flags + ["--steps", "2"]),
                              source=train.Batches([batch]), val=(batch[0][:2], refs))
    config = EngineConfig(canvases=(CanvasSpec(320, 416),), compute_dtype=torch.float32)
    trained = OCREngine.from_checkpoint("checkpoints/craft.npz", second["path"], config, device="cpu")
    image = np.asarray(np.random.default_rng(0).integers(0, 256, (300, 400)), np.float32)
    fresh = OCREngine.create(config=config, device="cpu")
    loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
    print(json.dumps({"loaded": loaded, "imported": imported, "refusals": refusals,
                      "start": second["start_step"], "steps": [r["step"] for r in second["log"]],
                      "states": sorted(os.listdir(os.path.join(tmp, "state"))),
                      "trained_reads": len(trained.readtext(image)) >= 0, "fresh_reads": len(fresh.readtext(image)) >= 0}))
    """
)

DATA_SCRIPT = TRAIN_BLOCKER + textwrap.dedent(
    """
    import importlib
    import json
    import os
    import pkgutil
    import sys
    import tempfile

    import torch

    torch.set_num_threads(2)
    import bbocr_tpu_torch

    imported = []
    for info in pkgutil.walk_packages(bbocr_tpu_torch.__path__, "bbocr_tpu_torch."):
        if not info.name.endswith("__main__"):
            importlib.import_module(info.name)
            imported.append(info.name)
    from bbocr_tpu_torch.cli import harvest_real_crops, make_examples, make_pipeline_crops, smoke
    from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
    from bbocr_tpu_torch.runtime.bucketing import CanvasSpec

    refusals = {}
    tmp = sys.argv[1]
    for name, call in (
        ("make_book", lambda: make_examples.make_book(tmp, 0, seed=0)),
        ("make_examples", lambda: make_examples.main(["--out", tmp, "--count", "1"])),
        ("smoke", lambda: smoke.main(["--device", "cpu"])),
        ("make_pipeline_crops", lambda: make_pipeline_crops.main(["--pages", "1", "--out", tmp, "--device", "cpu"])),
    ):
        try:
            call()
            refusals[name] = None
        except ImportError as e:
            refusals[name] = str(e)
    config = EngineConfig(canvases=(CanvasSpec(416, 320),), compute_dtype=torch.float32)
    engine = OCREngine.from_checkpoint("checkpoints/craft.npz", "checkpoints/crnn.npz", config, device="cpu")
    out = os.path.join(tmp, "crops")
    stats = harvest_real_crops.harvest_corpus(engine, out, books_filter="covers/book2")
    with open(os.path.join(out, "labels.json")) as f:
        labels = json.load(f)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
    print(json.dumps({"loaded": loaded, "imported": imported, "refusals": refusals, "stats": stats,
                      "labels": len(labels), "files": sorted(os.listdir(out)), "version": bbocr_tpu_torch.__version__}))
    """
)


def _run_blocked(script, *args):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "BB_OCR_BATCHING")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", script, *args], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _small_png(tmp_path):
    with Image.open(os.path.join(ROOT, "data", "real", "covers", "book1.png")) as img:
        small = np.asarray(img.convert("RGB"))[::5, ::5]
    png = tmp_path / "small.png"
    Image.fromarray(small).save(png)
    return str(png)


def test_port_runs_without_jax_pillow_cv2_jsonschema_requests(tmp_path):
    """The extractor with an engine passed in (no wrapper): the fast path
    and both re-reads on the PNG, the rotation route on the JPEG."""
    out = _run_blocked(SCRIPT, _small_png(tmp_path))
    assert out["loaded"] == []
    assert out["meta"]["_processing_info"]["structurer"] == "heuristic"
    assert "title" in out["meta"]
    assert out["photo"] == [800, 600, 3] and out["host_rectify"]
    assert out["small_route"][0] == "readtext_fast" and out["small_route"][-2:] == ["reread_low_conf", "reread_isbn"]
    assert out["camera_route"][:4] == ["readtext"] * 4
    assert out["camera_route"][4:] == ["reread_low_conf", "reread_isbn"]
    assert out["camera"]["_processing_info"]["ocr_boxes"] > 0


def test_slice_paths_run_without_jax_pillow_cv2_jsonschema_requests(tmp_path):
    """The CLI's extractor with no engine takes one shared engine wrapped in
    ``BatchingOCR`` (one single-image batch for the small PNG, cropped to its
    text); the stream equals ``readtext_batch``; ``warmup`` makes 2 calls on
    one canvas; bit-packed, pooled, coarse and unfolded-stem detection run."""
    out = _run_blocked(SLICE_SCRIPT, _small_png(tmp_path))
    assert out["loaded"] == [] and out["title"]
    assert out["wrapper"] == "BatchingOCR" and out["engines"] == 1 and out["calls"] == [1]
    assert out["stream_equal"] and out["stream_len"] == 3 and out["warmup"] == 2


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_evaluation_runs_without_jax_pillow_cv2_jsonschema_requests(tmp_path):
    """``evaluate_real`` on a cover (gray loaded without Pillow), then
    ``evaluate`` on a book through the shared engine, ``restructure`` and
    ``ab_summary`` over the artifact, and engines of the lite and published
    layouts, all with the imports of the card's machine."""
    out = _run_blocked(EVAL_SCRIPT, str(tmp_path / "eval_real.json"))
    assert out["loaded"] == [] and out["books"] == 1 and len(out["rotations"]) == 1 and out["rc"] == 0
    assert "tpu_mean_word_recall" in out["printed"] and "replayed" in out["printed"]
    assert "eval_real" in out["printed"] and '"per_field"' in out["printed"]
    assert out["detectors"] == ["CRAFTLite", "CRAFTPublished"]


def test_llm_route_and_host_clis_run_without_http_pillow_or_tesseract(tmp_path):
    """The default backend (Ollama, with its warm-up) through a session
    passed in, with a trace; the route without a session raises naming
    ``requests``; the encoders; and the host CLIs, on one small canvas."""
    out = _run_blocked(LLM_SCRIPT, str(tmp_path))
    assert out["loaded"] == []
    assert out["title"] == "T" and out["posts"] == 2 and out["steps"][-1] == "vlm_raw"
    assert "requests" in out["no_session"]
    assert out["thumb"] == [300, 225, 3] and min(out["sizes"]) > 0
    assert out["batch_ok"] == 2 and out["smoke_rc"] == 0
    printed = out["printed"]
    assert "book 1:" in printed and "SMOKE PASS" in printed and "IMG_0002.jpg" in printed
    assert '"op": "maps_download"' in printed


def test_service_and_pricing_run_without_http_libraries_or_bs4(tmp_path):
    """The scanner service with ``httpx``, ``bs4``, ``gspread``, ``google``
    and ``requests`` blocked: the warm-up (one batch and one call on the
    small canvas), both jobs on ``books/1`` done, the review and pricing
    requests and the CLI equal to the JAX outputs recorded in
    ``tests/data/pricing_jax.json``; without a session the model list
    answers 500 (``requests`` missing, as the JAX service's import raises),
    and without ``httpx`` the two network providers file it as their
    errors."""
    out = _run_blocked(SERVICE_SCRIPT, str(tmp_path))
    assert out["loaded"] == [] and out["idle"] and out["warmups"] == [2]
    assert out["health"]["pipeline_imported"] and out["health"]["pricing_available"]
    assert out["statuses"] == {"heuristic": ["queued", "running", "done"], "ollama": ["queued", "running", "done"]}
    assert out["titles"]["ollama"] == "Fenced Title" and out["titles"]["heuristic"]
    assert out["flow_equal"] and out["cli_equal"]
    assert out["bare_models"] == 500
    assert set(out["bare_errors"]) == {"google_books", "abebooks"}
    assert all("httpx" in e for e in out["bare_errors"].values())


def test_pagereader_runs_without_jax_flax_pillow_or_requests(tmp_path):
    """The extractor's ``tpu`` route with no session and no OCR'd photo, on
    a ``books/`` JPEG (the default bfloat16 client on the CPU, the
    checkpoint named as the service's UI names it), then ``vlm_eval
    --real`` on one cover."""
    out = _run_blocked(VLM_SCRIPT, str(tmp_path))
    assert out["loaded"] == []
    assert out["client"] == "NativeVLMClient" and out["dtype"] == "torch.bfloat16"
    assert out["path"] == "checkpoints/vlm.npz"
    assert out["meta"]["_processing_info"]["llm_backend"] == "tpu" and "title" in out["meta"]
    assert out["real"]["books"] == 1 and out["real"]["rows"][0]["book"] == "covers/book2"


def test_training_runs_without_jax_flax_optax_orbax_or_pillow(tmp_path):
    """Every module of the port imports with JAX, flax, optax, orbax and
    Pillow blocked; the generators, the CLI's synthetic source and
    ``vlm_eval --synthetic`` raise ``ImportError`` naming Pillow; the CLI's
    recognizer loop trains on a recorded batch, saves its state, resumes,
    and its checkpoint serves, as does ``OCREngine.create()``."""
    out = _run_blocked(TRAIN_SCRIPT, str(tmp_path))
    assert out["loaded"] == []
    assert {"bbocr_tpu_torch.train.trainer", "bbocr_tpu_torch.train.synth", "bbocr_tpu_torch.cli.train",
            "bbocr_tpu_torch.utils.train_ckpt"} <= set(out["imported"])
    assert all(why is not None and "Pillow" in why for why in out["refusals"].values()), out["refusals"]
    assert out["start"] == 1 and out["steps"] == [2] and out["states"] == ["step_1", "step_2"]
    assert out["trained_reads"] and out["fresh_reads"]


def test_port_sources_import_nothing_of_jax():
    """No module of ``bbocr_tpu_torch`` and not ``chip_smoke.py`` imports
    ``jax``, ``flax``, ``optax``, ``orbax`` or ``bbocr_tpu``, at the top or
    inside a function."""
    import ast

    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "bbocr_tpu"}
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(ROOT, "bbocr_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    found = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level else [])
            found += [(os.path.relpath(path, ROOT), n) for n in names if n.split(".")[0] in banned]
    assert len(paths) > 80 and found == []


def test_data_clis_run_without_jax_pillow_or_cv2(tmp_path):
    """Every module imports with JAX, Pillow and OpenCV blocked (the
    parallel package and the data CLIs among them); ``make_examples``,
    ``smoke`` without ``--books-dir`` and ``make_pipeline_crops`` raise
    ``ImportError`` naming Pillow; the harvest reads ``covers/book2`` (the
    port's gray read, its PNG writer) and keeps crops."""
    out = _run_blocked(DATA_SCRIPT, str(tmp_path))
    assert out["loaded"] == []
    assert {"bbocr_tpu_torch.cli.harvest_real_crops", "bbocr_tpu_torch.cli.make_examples",
            "bbocr_tpu_torch.cli.make_pipeline_crops", "bbocr_tpu_torch.parallel.mesh",
            "bbocr_tpu_torch.parallel.sharding", "bbocr_tpu_torch.parallel.collectives",
            "bbocr_tpu_torch.version"} <= set(out["imported"])
    assert all(why is not None and "Pillow" in why for why in out["refusals"].values()), out["refusals"]
    assert out["stats"]["books"] == 1 and out["stats"]["crops_kept"] == out["labels"] > 0
    assert len(out["files"]) == out["labels"] + 1 and out["version"] == "0.1.0"
