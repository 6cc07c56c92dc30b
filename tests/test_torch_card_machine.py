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
canvases, the coarse pass and the unfolded stem.
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

    BLOCKED = {"jax", "jaxlib", "flax", "bbocr_tpu", "PIL", "cv2", "jsonschema", "requests"}

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Blocker())
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
