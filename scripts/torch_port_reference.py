"""Write the JAX package's readings, and Pillow's JPEG decodings, as
references for the PyTorch port.

    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py \
        [--dtype float32|bfloat16] [--image data/real/covers/book1.png] [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --rotations \
        [--dtype float32|bfloat16] [--image data/real/photos/3/IMG_9687.jpg] [--out PATH]
    python scripts/torch_port_reference.py --jpeg-digests [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --default-route \
        [--dtype float32|bfloat16] [--canvas HxW] [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --covers [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --shared-engine-route [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --autocrop [--canvas 640x480] [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --engine-options [--canvas 416x320] [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --evaluate-real \
        [--dtype float32|bfloat16] [--canvas 416x320] [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --evaluate-books \
        [--dtype float32|bfloat16] [--canvas 416x320] [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --layouts [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --threshold-witness [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --encode [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --llm-route [--out PATH]

Default mode: the photo goes through ``_chain_gray_pallas`` and then
``OCREngine.readtext`` in the given compute type with the configuration the
PyTorch port runs (no host rectification, 8-bit wire, greedy decode, no
pooled or coarse detect). The default output is
``tests/data/book1_jax_f32.json`` or ``tests/data/book1_jax_bf16.json``.
``chip_smoke.py`` holds the port's float32 reading on the card against the
first (the same texts, quads within 1 px) and its default bfloat16 reading
against the second.

``--rotations``: a camera photo (default ``data/real/photos/3/IMG_9687.jpg``)
goes the way the JAX extractor takes it for the first OCR'd image with
``auto_rotate`` on: the chain, the PIL ``BILINEAR`` downscale to a long
side of 1600 px, then ``read_with_rotations`` with an engine of the given
compute type. It writes the chosen k, each rotation's (``rotation_score``,
``_wordlike_mass``) and the boxes of the chosen rotation to
``tests/data/<photo>_rotations_jax_f32.json`` (``_bf16`` for bfloat16).
``chip_smoke.py`` holds the card against ``IMG_9687_rotations_jax_f32.json``
and ``book1_rotations_jax_bf16.json`` (``--image data/real/covers/book1.png
--dtype bfloat16``).

``--default-route``: the JAX extractor's default route, as
``BookMetadataExtractor(llm_backend="heuristic")`` takes it with an
unwrapped ``OCREngine`` of the given compute type and otherwise default
configuration (host rectification, greedy decode; with no ``engine``
argument and ``BB_OCR_BATCHING`` unset the JAX extractor wraps its engine
in ``BatchingOCR``, which has neither the fast path nor the re-reads):
rotations for camera-shaped photos, the fast path for small upright ones,
then the low-confidence and ISBN re-reads. For each of the five covers of
``data/real/covers/`` and, on the full canvas menu,
``data/real/photos/3/IMG_9687.jpg``, it records the metadata JSON
(``_processing_info`` aside), the route, the chosen rotation, the boxes the
low-confidence re-read replaced, the ISBN re-read's answer and the final
texts, in ``tests/data/default_route_jax_f32.json`` (``_bf16``; with
``--canvas 640x480`` the engine has that one canvas and the file name ends
in ``_640x480``). ``chip_smoke.py`` holds the card against the full-menu
files, ``tests/test_torch_slice.py`` the CPU against the 640x480 one.

``--covers``: the five covers through the JAX extractor with rotations,
re-reads and the fast path off, a float32 engine on one 640x480 canvas,
device warps and greedy decode, to ``tests/data/covers_jax_f32_640x480.json``
(``tests/test_torch_slice.py::test_cover_metadata_matches_jax_extractor``).

``--shared-engine-route``: the JAX extractor as its users get it with no
``engine`` argument: ``BookMetadataExtractor(llm_backend="heuristic")``
takes ``_shared_engine()``, which wraps the engine in ``BatchingOCR``
(``BB_OCR_BATCHING`` unset), so there is no fast path and no re-read. The
engine ``_shared_engine()`` wraps is a float32 ``OCREngine`` with the
default configuration otherwise (``OCREngine.from_checkpoint`` is replaced
for the run to give it, since the shared engine's own is bfloat16). For
the five covers and ``IMG_9687.jpg`` it records the metadata JSON, the
route (``rotations``: four single-image batches; ``readtext``: one), the
chosen rotation and the texts, in
``tests/data/shared_engine_route_jax_f32.json`` (``chip_smoke.py`` phase 9).

``--autocrop``: for the five covers and ``IMG_9687.jpg``, the shape of the
preprocessed photo (``_chain_gray_pallas``) and the rectangle
``auto_crop_text_region(preprocessed, 128)`` gives (the extractor's
margin), then the metadata JSON and route of the JAX extractor with
``crop_for_ocr=True`` and otherwise default knobs on an unwrapped float32
engine of default configuration, to ``tests/data/autocrop_jax_f32.json``
(``chip_smoke.py`` phase 9). With ``--canvas 640x480``: the five covers'
JSON with ``crop_for_ocr=True`` and rotations, re-reads and the fast path
off, on one 640x480 canvas with device warps and greedy decode, to
``tests/data/autocrop_jax_f32_640x480.json``
(``tests/test_torch_autocrop.py``).

``--engine-options``: ``OCREngine.readtext`` of the preprocessed
``book1.png`` (1312x1050, canvas 1184x864) with a float32 engine of the
JAX default configuration (host rectification, greedy decode) and each
option on its own: ``wire_bits`` 4 and 2, ``detect_pool=2`` with
``detect_pool_min_area`` lowered to the canvas, ``detect_coarse=2`` and
``fold_gray_stem=False``, and no option; to
``tests/data/engine_options_jax_f32.json`` (``chip_smoke.py`` phase 9).
With ``--canvas 416x320``: the same options on one 416x320 canvas over
``book1.png`` in gray, ``cv2.INTER_AREA``-resized to 320x400, through
``readtext`` and ``readtext_fast``, to
``tests/data/engine_options_jax_f32_416x320.json``
(``tests/test_torch_wire.py``).

``--evaluate-real``: ``bbocr_tpu.cli.evaluate_real.evaluate_real`` over
the 21 books of ``data/real/`` (29 photos, each read at the four rotations,
then the low-confidence re-read), with its engine given the JAX default
configuration in the chosen compute type (``OCREngine.from_checkpoint`` is
replaced for the run). It writes the summary with each book's row
(rotations, results, lines, scores, fields), timings aside, to
``tests/data/evaluate_real_jax_f32.json`` (``_bf16``; ``chip_smoke.py``
phase 10). With ``--canvas 416x320`` the engine has that one canvas and the
run covers ``EVAL_REAL_SMALL`` (a cover, a one-photo and a two-photo book),
to ``evaluate_real_jax_f32_416x320.json`` (``tests/test_torch_evaluate.py``).

``--evaluate-books``: ``bbocr_tpu.cli.evaluate.evaluate_books`` over the 25
ground-truthed books of ``books/`` through the no-engine extractor, its
shared engine (wrapped in ``BatchingOCR``) given the JAX default
configuration in the chosen compute type, to
``tests/data/evaluate_books_jax_f32.json`` (``_bf16``; ``chip_smoke.py``
phase 10). With ``--canvas 416x320``: the first two books on that one
canvas, to ``evaluate_books_jax_f32_416x320.json``.

``--layouts``: the seed and the parameter shapes (``params`` and
``batch_stats``) of ``CRAFTLite`` and ``CRAFTPublished`` as flax builds
them, to ``tests/data/layouts_jax_shapes.json``: ``chip_smoke.py`` phase
10 builds engines of both layouts from those shapes and that seed.

``--threshold-witness``: where the float32 readings of ``evaluate_real``
differ (photos/5's ``IMG_9692.jpg`` turned by k = 3), both packages'
float32 CRAFT score maps on the CPU for that canvas: the largest
difference of each map, each map pixel whose detection mask differs with
both packages' region and affinity values, and a 9x9 patch of both region
maps around the first, to ``tests/data/threshold_witness_jax_f32.json``
(``chip_smoke.py`` phase 10a reads the card's maps against it).
``--encode``: what the JAX extractor's Pillow calls make of fixed inputs:
the photos of ``books/1`` to ``books/3``, two camera photos of
``data/real/photos/``, ``data/real/covers/book1.png``, and book1 as the
port's float32 chain preprocesses it on the CPU, written to
``tests/data/book1_preprocessed_port_f32.png`` (the card's chain differs
from the CPU's on a few pixels of the bicubic resize, so the card encodes
this file's pixels). For each input the SHA-256 of the
array, of ``_encode_jpeg_b64``'s JPEG at the cover's and the other photos'
settings (2000 px at quality 88, 3200 px at 95), and of the pixels of the
``_to_data_url`` preview (an 800 px ``thumbnail``, PNG) decoded by Pillow,
to ``tests/data/encode_jax_sha256.json`` (``chip_smoke.py`` phase 11a).

``--llm-route``: the JAX extractor with no ``engine`` argument (its shared
engine in ``BatchingOCR``, given the JAX default configuration in float32)
on ``books/1`` to ``books/3`` with ``capture_trace=True``, for the
``ollama``, ``openai`` and ``gemini`` backends through a recording fake
HTTP session with canned replies (fenced JSON; echoed prompt
placeholders; a Gemini 404 on the requested model, then the renamed
one). The replies and, per backend and book, each request (URL, headers,
timeout, the body without prompt and images, the prompt, the SHA-256 of
each JPEG sent), the metadata (``engine_timings`` aside, no trace) and
the trace's steps (previews aside), to ``tests/data/llm_route_jax_f32.json``
(``chip_smoke.py`` phase 11b).

``--jpeg-digests``: the SHA-256 of Pillow's RGB decoding of every JPEG in
``books/`` and ``data/real/photos/``, with its shape, to
``tests/data/jpeg_pillow_sha256.json``; then each file is decoded again by
the port's decoder (``bbocr_tpu_torch.native.jpeg``), which must give the
same bytes, and both total times are printed.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CAMERA_PHOTO = os.path.join(ROOT, "data", "real", "photos", "3", "IMG_9687.jpg")
MAX_DIM = 1600  # the JAX extractor's downscale limit for the first OCR'd image


def repository_jpegs():
    """Every JPEG of the repository's photo sets, sorted, as relative paths."""
    found = glob.glob(os.path.join(ROOT, "books", "*", "*")) + glob.glob(os.path.join(ROOT, "data", "real", "photos", "*", "*"))
    return sorted(os.path.relpath(p, ROOT) for p in found if p.lower().endswith((".jpg", ".jpeg")))


def _engine(dtype: str, **config):
    """The JAX engine in ``dtype``; by default in the configuration of the
    port's first slices (device warps, greedy decode)."""
    import jax.numpy as jnp

    from bbocr_tpu.runtime.engine import EngineConfig, OCREngine

    knobs = dict(host_rectify=False, wire_bits=8, decoder="greedy", detect_pool=1, detect_coarse=0)
    knobs.update(config)
    config = EngineConfig(compute_dtype=getattr(jnp, dtype), **knobs)
    return OCREngine.from_checkpoint(
        os.path.join(ROOT, "checkpoints", "craft.npz"),
        os.path.join(ROOT, "checkpoints", "crnn.npz"), config,
    )


def _preprocessed(path: str):
    import jax.numpy as jnp
    import numpy as np
    from PIL import Image

    from bbocr_tpu.ops import rgb_to_grayscale
    from bbocr_tpu.preprocess.chain import _chain_gray_pallas

    with Image.open(path) as img:
        rgb = np.asarray(img.convert("RGB"))
    h, w = rgb.shape[:2]
    gray = rgb_to_grayscale(jnp.asarray(rgb, jnp.float32))
    return np.asarray(_chain_gray_pallas(gray, int(h * 1.5), int(w * 1.5)))


def _boxes(results) -> dict:
    import numpy as np

    return {
        "texts": [t for _, t, _ in results],
        "quads": [np.asarray(q).round(3).tolist() for q, _, _ in results],
        "confidences": [round(float(c), 6) for _, _, c in results],
    }


def reading(image: str, dtype: str) -> dict:
    results = _engine(dtype).readtext(_preprocessed(image))
    return {"image": os.path.relpath(image, ROOT), "dtype": dtype, **_boxes(results)}


def rotations_reading(image: str, dtype: str) -> dict:
    """The JAX extractor's route for a camera photo, recorded per rotation."""
    import numpy as np
    from PIL import Image

    from bbocr_tpu.runtime.orient import _wordlike_mass, read_with_rotations, rotation_score

    pre = _preprocessed(image)
    h, w = pre.shape
    if max(h, w) > MAX_DIM:  # bbocr_tpu/extract/extractor.py::_ocr_text
        scale = MAX_DIM / max(h, w)
        pil = Image.fromarray(np.clip(pre, 0, 255).astype(np.uint8))
        pre = np.asarray(pil.resize((int(w * scale), int(h * scale)), Image.BILINEAR), np.float32)
    engine = _engine(dtype)
    reads = []

    class Recorder:
        def readtext(self, img):
            reads.append(engine.readtext(img))
            return reads[-1]

    results, k = read_with_rotations(Recorder(), pre)
    return {
        "image": os.path.relpath(image, ROOT), "dtype": dtype,
        "preprocessed_shape": list(pre.shape), "k": int(k),
        "scores": [[float(rotation_score(r)), float(_wordlike_mass(r))] for r in reads],
        **_boxes(results),
    }


COVERS = [os.path.join("data", "real", "covers", f"book{i}.png") for i in (1, 2, 4, 5, 6)]
CAMERA = os.path.relpath(CAMERA_PHOTO, ROOT)


class RouteRecorder:
    """Wraps an engine and records which route each photo took: the reads
    (``readtext`` per rotation, or ``readtext_fast``), the chosen rotation,
    the results the low-confidence re-read replaced, and the ISBN re-read's
    answer."""

    def __init__(self, engine):
        self.engine = engine
        self.reset()

    def reset(self):
        self.reads, self.replaced, self.isbn, self.final = [], [], None, []

    def readtext(self, image):
        self.reads.append(("readtext", self.engine.readtext(image)))
        return self.reads[-1][1]

    def readtext_fast(self, image):
        self.reads.append(("fast", self.engine.readtext_fast(image)))
        return self.reads[-1][1]

    def reread_low_conf(self, image, results, **kw):
        out = self.engine.reread_low_conf(image, results, **kw)
        self.replaced = [[i, a[1], b[1]] for i, (a, b) in enumerate(zip(results, out)) if a[1] != b[1]]
        self.final = out
        return out

    def reread_isbn(self, image, results):
        self.isbn = self.engine.reread_isbn(image, results)
        return self.isbn

    def timings(self):
        return self.engine.timings()

    def summary(self) -> dict:
        from bbocr_tpu.runtime.orient import _wordlike_mass, rotation_score

        kinds = [kind for kind, _ in self.reads]
        if kinds == ["readtext"] * 4:
            scores = [(rotation_score(r), _wordlike_mass(r)) for _, r in self.reads]
            k = max(range(4), key=lambda i: (scores[i], -i))
            route, chosen = "rotations", self.reads[k][1]
        else:
            k, route, chosen = None, "fast" if kinds == ["fast"] else "readtext", self.reads[-1][1]
        final = self.final or chosen
        return {"route": route, "k": k, "boxes": len(chosen), "replaced": self.replaced, "isbn": self.isbn,
                "texts": [t for _, t, _ in final]}


def extractor_readings(photos, dtype: str, canvas, knobs: dict, engine_config: dict) -> dict:
    """Metadata JSON and route of each photo through the JAX extractor."""
    from bbocr_tpu.extract.extractor import BookMetadataExtractor
    from bbocr_tpu.runtime.bucketing import CanvasSpec

    if canvas is not None:
        engine_config = dict(engine_config, canvases=(CanvasSpec(*canvas),))
    recorder = RouteRecorder(_engine(dtype, **engine_config))
    extractor = BookMetadataExtractor(llm_backend="heuristic", engine=recorder, **knobs)
    out = {}
    for rel in photos:
        recorder.reset()
        t0 = time.perf_counter()
        meta = extractor.extract_metadata_from_images([os.path.join(ROOT, rel)], ocr_image_indices=[0])
        meta.pop("_processing_info")
        out[rel] = {"meta": meta, **recorder.summary()}
        print(f"{rel}: {time.perf_counter() - t0:.1f} s, {json.dumps({k: v for k, v in out[rel].items() if k != 'meta'})}")
    return {"dtype": dtype, "canvas": canvas, "knobs": knobs, "engine_config": engine_config and {
        k: v for k, v in engine_config.items() if k != "canvases"}, "photos": out}


def default_route(dtype: str, canvas) -> dict:
    photos = COVERS + ([CAMERA] if canvas is None else [])
    # the JAX EngineConfig defaults but the compute type (BB_OCR_* unset)
    return extractor_readings(photos, dtype, canvas, {}, dict(
        host_rectify=True, wire_bits=8, decoder="greedy", detect_pool=1, detect_coarse=0))


def covers_without_route() -> dict:
    knobs = dict(auto_rotate=False, reread_low_conf=False, isbn_reread=False, fast_single=False, warm_model=False)
    return extractor_readings(COVERS, "float32", (640, 480), knobs, {})


class BatchRecorder:
    """The engine a ``BatchingOCR`` wraps: records each ``readtext_batch``
    call's image count and results."""

    def __init__(self, engine):
        self.engine, self.calls = engine, []

    def readtext_batch(self, images):
        out = self.engine.readtext_batch(images)
        self.calls.append((len(images), out))
        return out

    def timings(self):
        return self.engine.timings()

    def summary(self) -> dict:
        from bbocr_tpu.runtime.orient import _wordlike_mass, rotation_score

        if [n for n, _ in self.calls] == [1] * 4:
            reads = [r[0] for _, r in self.calls]
            scores = [(rotation_score(r), _wordlike_mass(r)) for r in reads]
            k = max(range(4), key=lambda i: (scores[i], -i))
            route, chosen = "rotations", reads[k]
        elif [n for n, _ in self.calls] == [1]:
            k, route, chosen = None, "readtext", self.calls[0][1][0]
        else:
            raise SystemExit(f"unexpected batches {[n for n, _ in self.calls]}")
        return {"route": route, "k": k, "boxes": len(chosen), "texts": [t for _, t, _ in chosen]}


def shared_engine_route() -> dict:
    """The no-engine JAX extractor through ``_shared_engine()``."""
    from bbocr_tpu.extract import extractor as jax_extractor
    from bbocr_tpu.runtime.batching import BatchingOCR
    from bbocr_tpu.runtime.engine import OCREngine

    recorder = BatchRecorder(_engine("float32", host_rectify=True))
    if os.environ.get("BB_OCR_BATCHING") is not None:
        raise SystemExit("unset BB_OCR_BATCHING: the recording is of the default wrapping")
    jax_extractor._ENGINE_CACHE.clear()
    original = OCREngine.__dict__["from_checkpoint"]
    OCREngine.from_checkpoint = classmethod(lambda cls, *args, **kw: recorder)
    try:
        extractor = jax_extractor.BookMetadataExtractor(llm_backend="heuristic")
        if not isinstance(extractor.engine, BatchingOCR):
            raise SystemExit(f"the shared engine is a {type(extractor.engine).__name__}")
    finally:
        OCREngine.from_checkpoint = original
    out = {}
    for rel in COVERS + [CAMERA]:
        recorder.calls = []
        t0 = time.perf_counter()
        meta = extractor.extract_metadata_from_images([os.path.join(ROOT, rel)], ocr_image_indices=[0])
        meta.pop("_processing_info")
        out[rel] = {"meta": meta, **recorder.summary()}
        print(f"{rel}: {time.perf_counter() - t0:.1f} s, {json.dumps({k: v for k, v in out[rel].items() if k != 'meta'})}")
    extractor.engine.close()
    jax_extractor._ENGINE_CACHE.clear()
    return {"dtype": "float32", "wrapper": "BatchingOCR", "photos": out}


def _preprocessed_photo(rel: str):
    """The photo as the JAX extractor preprocesses it (before any crop)."""
    import jax.numpy as jnp
    import numpy as np
    from PIL import Image

    from bbocr_tpu.preprocess import preprocess_for_book_cover

    with Image.open(os.path.join(ROOT, rel)) as img:
        rgb = np.asarray(img.convert("RGB"))
    return np.asarray(preprocess_for_book_cover(jnp.asarray(rgb, jnp.float32))[0])


def autocrop(canvas) -> dict:
    from bbocr_tpu.preprocess import auto_crop_text_region

    if canvas is not None:
        knobs = dict(auto_rotate=False, reread_low_conf=False, isbn_reread=False, fast_single=False,
                     warm_model=False, crop_for_ocr=True)
        return extractor_readings(COVERS, "float32", canvas, knobs, {})
    rects = {}
    for rel in COVERS + [CAMERA]:
        pre = _preprocessed_photo(rel)
        rect = auto_crop_text_region(pre, 128)
        rects[rel] = {"preprocessed_shape": list(pre.shape), "rect": None if rect is None else list(rect)}
        print(f"{rel}: {rects[rel]}")
    out = extractor_readings(COVERS + [CAMERA], "float32", None, {"crop_for_ocr": True}, dict(
        host_rectify=True, wire_bits=8, decoder="greedy", detect_pool=1, detect_coarse=0))
    for rel, entry in out["photos"].items():
        entry.update(rects[rel])
    return out


ENGINE_OPTIONS = {
    "default": {},
    "wire_bits=4": {"wire_bits": 4},
    "wire_bits=2": {"wire_bits": 2},
    "detect_pool=2": {"detect_pool": 2},
    "detect_coarse=2": {"detect_coarse": 2},
    "fold_gray_stem=False": {"fold_gray_stem": False},
}


def small_cover():
    """``book1.png`` in gray, resized to 320x400 with ``cv2.INTER_AREA``."""
    import cv2
    from PIL import Image
    import numpy as np

    with Image.open(os.path.join(ROOT, "data", "real", "covers", "book1.png")) as img:
        gray = cv2.cvtColor(np.asarray(img.convert("RGB")), cv2.COLOR_RGB2GRAY)
    return cv2.resize(gray, (320, 400), interpolation=cv2.INTER_AREA)


def engine_options(canvas) -> dict:
    from bbocr_tpu.runtime.bucketing import CanvasSpec, pick_canvas

    if canvas is None:
        image = _preprocessed(os.path.join(ROOT, "data", "real", "covers", "book1.png"))
        spec = pick_canvas(*image.shape)
        fns = ("readtext",)
    else:
        image, spec, fns = small_cover(), CanvasSpec(*canvas), ("readtext", "readtext_fast")
    out = {}
    for name, option in ENGINE_OPTIONS.items():
        config = dict(host_rectify=True, **option)
        if "detect_pool" in option:
            config["detect_pool_min_area"] = spec.height * spec.width
        if canvas is not None:
            config["canvases"] = (spec,)
        engine = _engine("float32", **config)
        out[name] = {"config": {k: v for k, v in config.items() if k != "canvases"}}
        for fn in fns:
            out[name][fn] = _boxes(getattr(engine, fn)(image))
        print(f"{name}: {json.dumps({fn: out[name][fn]['texts'] for fn in fns})}")
    return {"dtype": "float32", "image_shape": list(image.shape), "canvas": [spec.height, spec.width], "options": out}


EVAL_REAL_SMALL = ("covers/book2", "photos/3", "photos/4")


class _jax_config:
    """Within the block, ``OCREngine.from_checkpoint`` of the JAX package
    builds its engine with ``config`` (the caller's configuration ignored)."""

    def __init__(self, config):
        self.config = config

    def __enter__(self):
        from bbocr_tpu.runtime.engine import OCREngine

        self.original = OCREngine.__dict__["from_checkpoint"]
        config, original = self.config, self.original
        OCREngine.from_checkpoint = classmethod(
            lambda cls, craft, crnn, *_, **kw: original.__func__(cls, craft, crnn, config))

    def __exit__(self, *exc):
        from bbocr_tpu.runtime.engine import OCREngine

        OCREngine.from_checkpoint = self.original


def _default_config(dtype: str, canvas):
    """The JAX ``EngineConfig()`` in ``dtype`` (``BB_OCR_*`` must be unset),
    on one canvas when ``canvas`` is given."""
    import jax.numpy as jnp

    from bbocr_tpu.runtime.bucketing import CanvasSpec
    from bbocr_tpu.runtime.engine import EngineConfig

    knobs = [k for k in os.environ if k.startswith("BB_OCR_")]
    if knobs:
        raise SystemExit(f"unset {knobs}: the recording is of the default configuration")
    extra = {"canvases": (CanvasSpec(*canvas),)} if canvas else {}
    return EngineConfig(compute_dtype=getattr(jnp, dtype), **extra)


def _untimed(summary: dict) -> dict:
    summary.pop("total_seconds", None)
    for row in summary.get("details", []):
        row.pop("seconds", None)
    return summary


def evaluate_real_run(dtype: str, canvas) -> dict:
    from bbocr_tpu.cli.evaluate_real import evaluate_real

    with _jax_config(_default_config(dtype, canvas)):
        summary = evaluate_real(
            os.path.join(ROOT, "data", "real"),
            craft=os.path.join(ROOT, "checkpoints", "craft.npz"),
            crnn=os.path.join(ROOT, "checkpoints", "crnn.npz"),
            books_filter=EVAL_REAL_SMALL if canvas else None,
        )
    print(json.dumps({k: v for k, v in summary.items() if k != "details"}))
    return {"dtype": dtype, "canvas": canvas, **_untimed(summary)}


def evaluate_books_run(dtype: str, canvas) -> dict:
    from bbocr_tpu.cli.evaluate import evaluate_books
    from bbocr_tpu.extract import extractor as jax_extractor

    jax_extractor._ENGINE_CACHE.clear()
    try:
        with _jax_config(_default_config(dtype, canvas)):
            summary = evaluate_books(os.path.join(ROOT, "books"), limit=2 if canvas else None)
    finally:
        engine = jax_extractor._ENGINE_CACHE.pop("engine", None)
        if engine is not None and hasattr(engine, "close"):
            engine.close()
    print(json.dumps({k: v for k, v in summary.items() if k != "details"}))
    return {"dtype": dtype, "canvas": canvas, **_untimed(summary)}


LAYOUT_SEED = 11


def layouts() -> dict:
    """The flax parameter shapes of the two detector layouts."""
    import jax
    import jax.numpy as jnp

    from bbocr_tpu.models.craft import CRAFTLite, CRAFTPublished

    out = {"seed": LAYOUT_SEED}
    for name, model in (("lite", CRAFTLite(dtype=jnp.float32)), ("published", CRAFTPublished(dtype=jnp.float32))):
        tree = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
        out[name] = jax.tree_util.tree_map(lambda a: list(a.shape), dict(tree))
    return out


# photos/5's second photo, turned by k = 3: the rotation where the float32
# readings of the two packages differ in one box (chip_smoke.py phase 10a)
WITNESS_PHOTO = ("photos/5", "IMG_9692.jpg", 3)


def threshold_witness() -> dict:
    """Both packages' float32 CRAFT score maps (CPU) for the canvas that
    ``evaluate_real`` gives ``WITNESS_PHOTO``: the largest difference of
    each map, every map pixel whose detection mask differs, with both
    packages' values there, and a 9x9 patch of both region maps around the
    first such pixel."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from bbocr_tpu.cli.evaluate_real import _load_gray
    from bbocr_tpu.runtime import bucketing
    from bbocr_tpu.runtime.engine import EngineConfig, OCREngine, _host_resize, _to_gray_u8
    from bbocr_tpu_torch.runtime import EngineConfig as PortConfig
    from bbocr_tpu_torch.runtime import OCREngine as PortEngine

    book, name, k = WITNESS_PHOTO
    craft, crnn = (os.path.join(ROOT, "checkpoints", f) for f in ("craft.npz", "crnn.npz"))
    gray = _to_gray_u8(np.rot90(_load_gray(os.path.join(ROOT, "data", "real", book, name)), k))
    jax_engine = OCREngine.from_checkpoint(craft, crnn, EngineConfig(compute_dtype=jnp.float32))
    canvas = bucketing.pick_canvas(gray.shape[0], gray.shape[1], jax_engine.config.canvases)
    _, oh, ow = bucketing.letterbox_params(gray.shape[0], gray.shape[1], canvas)
    batch = np.zeros((1, canvas.height, canvas.width), np.float32)
    batch[0, :oh, :ow] = _host_resize(gray, oh, ow)
    if not jax_engine._fold:
        raise SystemExit("the witness is of the default folded gray stem")
    jax_maps = np.asarray(jax.jit(jax_engine.craft_infer.apply)(jax_engine.craft_params, jnp.asarray(batch)[..., None]))[0]
    jax_mask = np.asarray(jax_engine._detect(jax_engine.craft_params, jnp.asarray(batch), 1)[0])[0].astype(bool)
    port = PortEngine.from_checkpoint(craft, crnn, PortConfig(compute_dtype=torch.float32), device="cpu")
    with torch.no_grad():
        port_maps = port.craft(port.craft_input(torch.from_numpy(batch))).numpy()[0].transpose(1, 2, 0)
    det = jax_engine.config.detection
    masks = [(m[..., 0] > det.low_text) | (m[..., 1] > det.link_threshold) for m in (port_maps, jax_maps)]
    if not np.array_equal(masks[1], jax_mask):
        raise SystemExit("the JAX maps' mask differs from the JAX engine's own detect")
    pixels = np.argwhere(masks[0] != masks[1])
    out = {
        "book": book, "image": name, "k": k, "canvas": [canvas.height, canvas.width],
        "map_shape": list(port_maps.shape[:2]), "low_text": det.low_text, "link_threshold": det.link_threshold,
        "max_abs_diff_region": float(np.abs(port_maps[..., 0] - jax_maps[..., 0]).max()),
        "max_abs_diff_affinity": float(np.abs(port_maps[..., 1] - jax_maps[..., 1]).max()),
        "pixels": [{"y": int(y), "x": int(x), "port_region": float(port_maps[y, x, 0]),
                    "jax_region": float(jax_maps[y, x, 0]), "port_affinity": float(port_maps[y, x, 1]),
                    "jax_affinity": float(jax_maps[y, x, 1])} for y, x in pixels],
    }
    if len(pixels):
        y, x = (int(v) for v in pixels[0])
        window = (slice(max(y - 4, 0), y + 5), slice(max(x - 4, 0), x + 5), 0)
        out["patch_origin"] = [window[0].start, window[1].start]
        out["port_region_patch"] = port_maps[window].tolist()
        out["jax_region_patch"] = jax_maps[window].tolist()
    print(json.dumps({k: v for k, v in out.items() if not k.endswith("_patch")}))
    return out


def jpeg_digests() -> dict:
    import numpy as np
    from PIL import Image

    from bbocr_tpu_torch.native import jpeg

    digests, t_pillow, t_port = {}, 0.0, 0.0
    for rel in repository_jpegs():
        path = os.path.join(ROOT, rel)
        t0 = time.perf_counter()
        with Image.open(path) as img:
            rgb = np.asarray(img.convert("RGB"))
        t_pillow += time.perf_counter() - t0
        digests[rel] = {"shape": list(rgb.shape), "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
        jpeg.load()
        t0 = time.perf_counter()
        ours = jpeg.read_jpeg(path)
        t_port += time.perf_counter() - t0
        if ours.shape != rgb.shape or not np.array_equal(ours, rgb):
            raise SystemExit(f"{rel}: the port's decoder differs from Pillow")
    print(f"{len(digests)} JPEGs, all bit-exact: Pillow {t_pillow:.3f} s, the port's decoder {t_port:.3f} s (CPU, one thread)")
    return digests


ENCODE_SETTINGS = ((2000, 88), (3200, 95))  # the extractor's cover and other photos
ENCODE_PHOTOS = [f"books/{b}/IMG_000{i}.jpg" for b in (1, 2, 3) for i in range(3)] + [
    "data/real/photos/3/IMG_9687.jpg", "data/real/photos/10/IMG_9703.jpg", "data/real/covers/book1.png"]
PREPROCESSED_BOOK1 = "tests/data/book1_preprocessed_port_f32.png"


def _sha(data) -> str:
    import numpy as np

    return hashlib.sha256(data.tobytes() if isinstance(data, np.ndarray) else data).hexdigest()


def encode_reference() -> dict:
    import base64
    import io

    import numpy as np
    import torch
    from PIL import Image

    from bbocr_tpu.extract.extractor import BookMetadataExtractor
    from bbocr_tpu_torch.io import load_rgb
    from bbocr_tpu_torch.preprocess import preprocess_for_book_cover

    torch.set_num_threads(2)
    pre = preprocess_for_book_cover(load_rgb(os.path.join(ROOT, "data", "real", "covers", "book1.png")), device="cpu")[0]
    Image.fromarray(pre.numpy().astype(np.uint8)).save(os.path.join(ROOT, PREPROCESSED_BOOK1), optimize=True)
    out = {"settings": [list(s) for s in ENCODE_SETTINGS], "inputs": {}}
    for rel in ENCODE_PHOTOS + [PREPROCESSED_BOOK1]:
        arr = BookMetadataExtractor._load_rgb(os.path.join(ROOT, rel))
        if rel == PREPROCESSED_BOOK1:  # gray float32, as the extractor holds a preprocessed photo
            arr = np.asarray(Image.open(os.path.join(ROOT, rel)), np.float32)
        url = BookMetadataExtractor._to_data_url(arr)
        preview = np.asarray(Image.open(io.BytesIO(base64.b64decode(url.split(",", 1)[1]))))
        out["inputs"][rel] = {
            "shape": list(arr.shape), "dtype": str(arr.dtype), "sha256": _sha(np.ascontiguousarray(arr)),
            "jpeg_sha256": [_sha(base64.b64decode(BookMetadataExtractor._encode_jpeg_b64(arr, d, q)))
                            for d, q in ENCODE_SETTINGS],
            "preview_shape": list(preview.shape), "preview_sha256": _sha(np.ascontiguousarray(preview)),
        }
        print(rel, out["inputs"][rel]["shape"], "->", out["inputs"][rel]["preview_shape"])
    return out


LLM_BOOKS = ["1", "2", "3"]
LLM_MODELS = {"ollama": "gemma3:4b", "openai": "gpt-4o", "gemini": "gemini-1.5-flash"}
LLM_REPLIES = {
    "ollama": '```json\n{"title": "Fenced Title", "authors": ["A. Writer"], "year": "1994", "isbn_13": null}\n```',
    "openai": ('{"title": "Echoed Title", "subtitle": "string | null", "authors": ["string", "..."] | [], '
               '"publisher": "string | null", "year": "YYYY | null", "page_count": "integer | null", '
               '"price": {"currency": "string | null", "amount": "float | null"}}'),
    "gemini": 'Here it is: ```json\n{"title": "Gemini Title", "categories": ["Fiction"]}\n``` done',
}
LLM_ENV = {"OPENAI_API_KEY": "sk-test", "GEMINI_API_KEY": "g-test"}


class CannedSession:
    """The fake HTTP session of the LLM-route references: answers each
    backend with its canned reply (Gemini: 404 for the requested model
    name, then 200) and records every post."""

    def __init__(self, replies: dict, gemini_missing: str):
        self.replies, self.gemini_missing, self.posts = replies, gemini_missing, []

    def post(self, url, json=None, headers=None, timeout=None):
        self.posts.append((url, json, headers, timeout))
        if "/api/generate" in url:
            status, payload = 200, {"response": self.replies["ollama"]}
        elif "/chat/completions" in url:
            status, payload = 200, {"choices": [{"message": {"content": self.replies["openai"]}}],
                                    "usage": {"prompt_tokens": 1500, "completion_tokens": 90}}
        elif f"/models/{self.gemini_missing}:" in url:
            status, payload = 404, {}
        else:
            status, payload = 200, {"candidates": [{"content": {"parts": [{"text": self.replies["gemini"]}]}}],
                                    "usageMetadata": {"promptTokenCount": 1400, "candidatesTokenCount": 70}}
        return type("Reply", (), {"status_code": status, "text": "", "json": lambda self: payload})()


def summarize_post(post) -> dict:
    """A recorded request: URL (no query), headers, timeout, the body
    without its prompt and images, the prompt, and each JPEG's SHA-256."""
    import base64
    import copy

    url, body, headers, timeout = post
    body = copy.deepcopy(body)
    if "/api/generate" in url:
        prompt, images = body.pop("prompt"), body.pop("images", [])
    elif "/chat/completions" in url:
        content = body["messages"][0].pop("content")
        prompt, images = content[0]["text"], [c["image_url"]["url"].split(",", 1)[1] for c in content[1:]]
    else:
        parts = body["contents"][0].pop("parts")
        prompt, images = parts[0]["text"], [p["inline_data"]["data"] for p in parts[1:]]
    return {"url": url.split("?")[0], "headers": headers, "timeout": list(timeout), "body": body, "prompt": prompt,
            "image_sha256": [_sha(base64.b64decode(b)) for b in images]}


def route_record(meta: dict, session) -> dict:
    meta = dict(meta)
    trace = meta.pop("_trace")
    info = dict(meta.pop("_processing_info"))
    info.pop("engine_timings", None)
    steps = [{k: v for k, v in step.items() if k != "images"} for step in trace["steps"]]
    return {"meta": {**meta, "_processing_info": info}, "steps": steps,
            "posts": [summarize_post(p) for p in session.posts]}


def book_images(book: str) -> list:
    directory = os.path.join(ROOT, "books", book)
    return [os.path.join(directory, f) for f in sorted(os.listdir(directory)) if f.lower().endswith(".jpg")]


def llm_route() -> dict:
    from bbocr_tpu.extract import extractor as jax_extractor

    os.environ.update(LLM_ENV)
    for key in ("OPENAI_BASE_URL", "GOOGLE_API_KEY", "GOOGLE_API_BASE"):
        os.environ.pop(key, None)
    runs = {}
    jax_extractor._ENGINE_CACHE.clear()
    try:
        with _jax_config(_default_config("float32", None)):
            for backend, model in LLM_MODELS.items():
                ext = jax_extractor.BookMetadataExtractor(llm_backend=backend, model=model, warm_model=False)
                runs[backend] = {}
                for book in LLM_BOOKS:
                    ext.session = CannedSession(LLM_REPLIES, LLM_MODELS["gemini"])
                    t0 = time.perf_counter()
                    meta = ext.extract_metadata_from_images(book_images(book), capture_trace=True)
                    runs[backend][book] = route_record(meta, ext.session)
                    print(f"{backend} book {book}: {time.perf_counter() - t0:.1f} s, "
                          f"{json.dumps({k: v for k, v in meta.items() if not k.startswith('_')})}")
    finally:
        engine = jax_extractor._ENGINE_CACHE.pop("engine", None)
        if engine is not None and hasattr(engine, "close"):
            engine.close()
    return {"dtype": "float32", "books": LLM_BOOKS, "models": LLM_MODELS, "replies": LLM_REPLIES, "env": LLM_ENV,
            "runs": runs}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--rotations", action="store_true")
    mode.add_argument("--jpeg-digests", action="store_true")
    mode.add_argument("--default-route", action="store_true")
    mode.add_argument("--covers", action="store_true")
    mode.add_argument("--shared-engine-route", action="store_true")
    mode.add_argument("--autocrop", action="store_true")
    mode.add_argument("--engine-options", action="store_true")
    mode.add_argument("--evaluate-real", action="store_true")
    mode.add_argument("--evaluate-books", action="store_true")
    mode.add_argument("--layouts", action="store_true")
    mode.add_argument("--threshold-witness", action="store_true")
    mode.add_argument("--encode", action="store_true")
    mode.add_argument("--llm-route", action="store_true")
    p.add_argument("--canvas", default=None,
                   help="HxW: one canvas instead of the menu (--default-route, --autocrop, --engine-options, "
                        "--evaluate-real, --evaluate-books)")
    p.add_argument("--image", default=None)
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    data = os.path.join(ROOT, "tests", "data")
    suffix = {"float32": "f32", "bfloat16": "bf16"}[args.dtype]
    canvas = tuple(int(v) for v in args.canvas.split("x")) if args.canvas else None
    tail = f"_{args.canvas}" if args.canvas else ""
    if args.default_route:
        out = default_route(args.dtype, canvas)
        out_path = args.out or os.path.join(data, f"default_route_jax_{suffix}{tail}.json")
    elif args.shared_engine_route:
        out = shared_engine_route()
        out_path = args.out or os.path.join(data, "shared_engine_route_jax_f32.json")
    elif args.autocrop:
        out = autocrop(canvas)
        out_path = args.out or os.path.join(data, f"autocrop_jax_f32{tail}.json")
    elif args.engine_options:
        out = engine_options(canvas)
        out_path = args.out or os.path.join(data, f"engine_options_jax_f32{tail}.json")
    elif args.evaluate_real:
        out = evaluate_real_run(args.dtype, canvas)
        out_path = args.out or os.path.join(data, f"evaluate_real_jax_{suffix}{tail}.json")
    elif args.evaluate_books:
        out = evaluate_books_run(args.dtype, canvas)
        out_path = args.out or os.path.join(data, f"evaluate_books_jax_{suffix}{tail}.json")
    elif args.layouts:
        out = layouts()
        out_path = args.out or os.path.join(data, "layouts_jax_shapes.json")
    elif args.threshold_witness:
        out = threshold_witness()
        out_path = args.out or os.path.join(data, "threshold_witness_jax_f32.json")
    elif args.encode:
        out = encode_reference()
        out_path = args.out or os.path.join(data, "encode_jax_sha256.json")
    elif args.llm_route:
        out = llm_route()
        out_path = args.out or os.path.join(data, "llm_route_jax_f32.json")
    elif args.covers:
        out = covers_without_route()
        out_path = args.out or os.path.join(data, "covers_jax_f32_640x480.json")
    elif args.jpeg_digests:
        out = jpeg_digests()
        out_path = args.out or os.path.join(data, "jpeg_pillow_sha256.json")
    elif args.rotations:
        image = args.image or CAMERA_PHOTO
        out = rotations_reading(image, args.dtype)
        stem = os.path.splitext(os.path.basename(image))[0]
        out_path = args.out or os.path.join(data, f"{stem}_rotations_jax_{suffix}.json")
        print(f"k = {out['k']}, scores {out['scores']}")
    else:
        out = reading(args.image or os.path.join(ROOT, "data", "real", "covers", "book1.png"), args.dtype)
        out_path = args.out or os.path.join(data, f"book1_jax_{suffix}.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"{len(out.get('texts', out.get('photos', out.get('options', out.get('details', out)))))} entries -> {out_path}")


if __name__ == "__main__":
    main()
