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
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --server-route [--canvas 416x320] [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --pricing [--out PATH]

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

``--server-route``: the JAX scanner service (``bbocr_tpu/server/app.py``)
served on 127.0.0.1 and driven over HTTP with the standard library: the
photos of ``books/1`` to ``books/3`` posted to ``/api/process_images``
with ``run_ocr=true``, once with ``llm_backend=heuristic`` and once with
``ollama`` (the extractors' LLM session the canned one of ``--llm-route``),
each job followed on ``/api/job_stream`` and ``/api/trace_stream`` until it
ends, then read on ``/api/job_result``. Its shared engine is float32 in the
JAX default configuration. Per backend and book: the job's status, its
metadata (trace dropped, ``engine_timings`` aside), the trace's steps and
the LLM requests, to ``tests/data/server_route_jax_f32.json``
(``chip_smoke.py`` phase 12). With ``--canvas 416x320``: ``books/1`` only,
on that one canvas, to ``server_route_jax_f32_416x320.json``
(``tests/test_torch_server.py``).

``--pricing`` (after ``--server-route``): the JAX pricing outputs on canned
HTTP clients (``CannedHttp``: the Google Books payload of
``tests/test_google_books.py``; AbeBooks pages by search keywords): the
AbeBooks ``parse_results_html`` of the recorded page of
``tests/test_pricing.py``, of seeded synthetic pages
(``synthetic_abebooks_page``) and of the page the lookup is served, each
with three queries; the JAX service's review and pricing requests
(``pricing_flow``: accept the ollama job's metadata of ``books/1``, take it
back, look up, select, finalize both ways, the aliases), masked; and
``bbocr_tpu.cli.pricing --from-json <accepted> --select``; to
``tests/data/pricing_jax.json`` (``chip_smoke.py`` phase 12,
``tests/test_torch_pricing.py``).

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
import re
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


# ---------------------------------------------------------------------------
# The scanner service and pricing: a stdlib HTTP client, the service runner,
# canned pricing clients, synthetic AbeBooks pages (importable without JAX:
# ``chip_smoke.py`` phase 12 and the tests drive the port's service with them)
# ---------------------------------------------------------------------------

SERVER_BOOKS = ["1", "2", "3"]
SERVER_BACKENDS = ["heuristic", "ollama"]
JOB_TIMEOUT_S = 600.0


def http_call(base: str, method: str, path: str, body: bytes = b"", headers=None, timeout: float = 60.0):
    """One request with ``http.client`` -> (status, lower-cased headers, body bytes)."""
    import http.client
    import urllib.parse

    url = urllib.parse.urlsplit(base)
    conn = http.client.HTTPConnection(url.hostname, url.port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def http_json(base: str, method: str, path: str, payload=None, timeout: float = 60.0):
    """A JSON request (``payload`` None: no body) -> (status, decoded JSON or text)."""
    body = b"" if payload is None else json.dumps(payload).encode()
    headers = {"Content-Type": "application/json"} if payload is not None else {}
    status, resp_headers, data = http_call(base, method, path, body, headers, timeout)
    if resp_headers.get("content-type", "").startswith("application/json"):
        return status, json.loads(data)
    return status, data.decode("utf-8", "replace")


def multipart(fields: dict, files: list):
    """``fields`` {name: value} and ``files`` [(field, filename, content type,
    bytes)] -> (body, Content-Type header) of a multipart/form-data request."""
    boundary = "bbocrboundary" + hashlib.sha256(repr(sorted(fields.items())).encode()).hexdigest()[:16]
    parts = []
    for name, value in fields.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"\r\n\r\n{value}\r\n'.encode())
    for field, filename, ctype, data in files:
        head = (f'--{boundary}\r\nContent-Disposition: form-data; name="{field}"; filename="{filename}"\r\n'
                f"Content-Type: {ctype}\r\n\r\n")
        parts.append(head.encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def sse_frames(base: str, path: str, stop, timeout: float = JOB_TIMEOUT_S, t0=None) -> list:
    """Follows a server-sent-event stream: [(seconds since ``t0``, default
    the call, frame)] for each ``data:`` frame, until ``stop(frame)`` is
    true or the server closes the stream."""
    import http.client
    import urllib.parse

    url = urllib.parse.urlsplit(base)
    t0 = time.perf_counter() if t0 is None else t0
    conn = http.client.HTTPConnection(url.hostname, url.port, timeout=timeout)
    frames = []
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = []
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode("utf-8").rstrip("\r\n")
            if line.startswith("data: "):
                data.append(line[len("data: "):])
            elif not line and data:
                frame = json.loads("\n".join(data))
                data = []
                frames.append((time.perf_counter() - t0, frame))
                if stop(frame):
                    break
    finally:
        conn.close()
    return frames


class ServiceThread:
    """Serves a scanner service's ``app`` on 127.0.0.1 at a free port, in a
    thread with its own event loop, as ``tests/test_server.py`` does;
    ``base`` is its URL. Leaving the block cancels the live connections and
    stops the loop."""

    def __init__(self, service):
        self.service, self.base = service, None

    def __enter__(self):
        import asyncio
        import socket
        import threading

        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        self.loop = asyncio.new_event_loop()
        self.base = f"http://127.0.0.1:{port}"

        def run():
            asyncio.set_event_loop(self.loop)
            try:
                self.loop.run_until_complete(self.service.app.serve("127.0.0.1", port))
            except RuntimeError:
                pass  # the loop was stopped

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        for _ in range(200):
            try:
                http_call(self.base, "GET", "/api/health", timeout=2)
                return self
            except OSError:
                time.sleep(0.05)
        raise RuntimeError("the service did not start")

    def __exit__(self, *exc):
        import asyncio

        asyncio.run_coroutine_threadsafe(self.service.app.shutdown(), self.loop).result(timeout=10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        if not self.thread.is_alive():
            self.loop.close()


def wait_jobs_idle(service, timeout: float = JOB_TIMEOUT_S) -> bool:
    """Waits until no job of ``service`` is queued or running; True if so."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        with service.jobs._lock:
            if not any(j["status"] in ("queued", "running") for j in service.jobs.jobs.values()):
                return True
        time.sleep(0.05)
    return False


def run_job(base: str, photos: list, form: dict) -> dict:
    """Posts ``photos`` (paths) to ``/api/process_images`` with ``form``,
    follows ``/api/job_stream`` and ``/api/trace_stream`` until the job
    ends, then reads ``/api/job_result``, ``/api/trace_poll`` and every
    ``/api/log_poll`` page. Prints nothing: while a job runs the service
    sends every print of the process into its log."""
    import threading

    files = []
    for path in photos:
        with open(path, "rb") as f:
            files.append(("images", os.path.basename(path), "image/jpeg", f.read()))
    body, ctype = multipart(form, files)
    t0 = time.perf_counter()
    status, _, data = http_call(base, "POST", "/api/process_images", body, {"Content-Type": ctype})
    posted = json.loads(data)
    if status != 200:
        return {"post_status": status, "post": posted}
    job_id = posted["id"]
    streams = {}

    def follow(kind, stop):
        streams[kind] = sse_frames(base, f"/api/{kind}?id={job_id}", stop, t0=t0)

    threads = [threading.Thread(target=follow, args=("trace_stream", lambda f: f.get("type") == "end")),
               threading.Thread(target=follow, args=("job_stream", lambda f: f.get("status") in ("done", "error")))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOB_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    _, result = http_json(base, "GET", f"/api/job_result?id={job_id}")
    _, traces = http_json(base, "GET", f"/api/trace_poll?id={job_id}&after=0")
    logs, after = [], 0
    while True:
        _, page = http_json(base, "GET", f"/api/log_poll?id={job_id}&after={after}")
        if not page["items"]:
            break
        logs += [item["line"] for item in page["items"]]
        after = page["items"][-1]["seq"]
    trace_frames = [(s, f) for s, f in streams.get("trace_stream", []) if "trace" in f]
    return {
        "id": job_id, "post_status": status, "post": posted, "seconds": seconds, "result": result,
        "statuses": [f.get("status") for _, f in streams.get("job_stream", []) if "status" in f],
        "trace_frames": len(trace_frames), "trace_polled": len(traces["items"]),
        "first_trace_s": trace_frames[0][0] if trace_frames else None, "logs": logs,
    }


def job_record(job: dict, posts) -> dict:
    """What a job's result must match: its metadata (the trace dropped;
    ``engine_timings`` and the port's ``ocr_boxes``, which the JAX
    extractor's info lacks, aside), the trace's steps (previews aside) and
    the LLM requests the job made."""
    if job["result"].get("status") != "done":
        return {"status": job["result"].get("status"), "error": job["result"].get("error")}
    meta = dict(job["result"]["metadata"])
    trace = meta.pop("_trace", {"steps": []})
    info = dict(meta.pop("_processing_info"))
    info.pop("engine_timings", None)
    boxes = info.pop("ocr_boxes", None)
    steps = [{k: v for k, v in step.items() if k != "images"} for step in trace["steps"]]
    record = {"status": job["result"]["status"], "meta": {**meta, "_processing_info": info}, "steps": steps,
              "posts": [summarize_post(p) for p in posts]}
    return record if boxes is None else {**record, "ocr_boxes": boxes}


def server_jobs(base: str, session, books=SERVER_BOOKS, backends=SERVER_BACKENDS) -> tuple:
    """Each book of ``books/`` posted once per backend with ``run_ocr=true``:
    ({backend: {book: record}}, {backend: {book: job}}). ``session`` is the
    canned session the service's extractors use."""
    records, jobs = {}, {}
    for backend in backends:
        records[backend], jobs[backend] = {}, {}
        for book in books:
            start = len(session.posts)
            job = run_job(base, book_images(book), {"llm_backend": backend, "model": LLM_MODELS["ollama"],
                                                    "run_ocr": "true"})
            jobs[backend][book] = job
            records[backend][book] = job_record(job, session.posts[start:]) if "result" in job else job
    return records, jobs


def server_route(canvas) -> dict:
    """The JAX service's jobs on ``books/`` (``books/1`` only with a canvas),
    its shared engine float32 in the JAX default configuration, the LLM
    through the canned session."""
    import tempfile

    from bbocr_tpu.extract import extractor as jax_extractor
    from bbocr_tpu.server.app import ScannerService

    books = SERVER_BOOKS if canvas is None else SERVER_BOOKS[:1]
    session = CannedSession(LLM_REPLIES, LLM_MODELS["gemini"])
    jax_extractor._ENGINE_CACHE.clear()
    try:
        with tempfile.TemporaryDirectory() as tmp, _jax_config(_default_config("float32", canvas)):
            service = ScannerService(data_dir=tmp, books_dir=os.path.join(ROOT, "books"))
            build = service._build_extractor

            def with_session(**knobs):
                ext = build(**knobs)
                ext.session = session
                return ext

            service._build_extractor = with_session
            with ServiceThread(service) as srv:
                records, jobs = server_jobs(srv.base, session, books)
    finally:
        engine = jax_extractor._ENGINE_CACHE.pop("engine", None)
        if engine is not None and hasattr(engine, "close"):
            engine.close()
    for backend, by_book in jobs.items():
        for book, job in by_book.items():
            print(f"{backend} book {book}: {job['seconds']:.1f} s, {job['statuses']}, "
                  f"{json.dumps({k: v for k, v in records[backend][book]['meta'].items() if not k.startswith('_')})}")
    return {"dtype": "float32", "canvas": canvas, "books": books, "backends": SERVER_BACKENDS,
            "model": LLM_MODELS["ollama"], "replies": LLM_REPLIES, "runs": records}


class _CannedResponse:
    def __init__(self, url: str, status: int, payload=None, text: str = ""):
        self.url, self.status_code, self._payload, self.text = url, status, payload, text

    def raise_for_status(self):
        if self.status_code >= 400:
            raise RuntimeError(f"canned HTTP {self.status_code} for {self.url}")

    def json(self):
        return self._payload


class _CannedClient:
    def __init__(self, http, kwargs):
        self.http, self.kwargs = http, kwargs

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        return False

    async def get(self, url, params=None):
        params = dict(params or {})
        self.http.requests.append({"url": url, "params": params, "client": self.kwargs})
        if "googleapis.com" in url:
            return _CannedResponse(url, 200, payload=self.http.payload)
        page = self.http.pages.get(params.get("kn"))
        return _CannedResponse(url, 404 if page is None else 200, text=page or "")


class CannedHttp:
    """Stands in for ``httpx.AsyncClient`` in the pricing references (call
    it as the class is called): the Google Books API answers ``payload``,
    an AbeBooks search the page of ``pages`` for its keywords (``kn``) and
    404 for others; every GET is recorded in ``requests``."""

    def __init__(self, payload: dict, pages: dict):
        self.payload, self.pages, self.requests = payload, pages, []

    def __call__(self, **kwargs):
        return _CannedClient(self, kwargs)


_CARD_OPEN = {
    "srp": ('<li class="srp-list-item">', "</li>"),
    "result": ('<div class="cf"><div class="result">', "</div></div>"),
    "search": ('<div class="cf search-result">', "</div>"),
    "item": ('<div class="srp-item"><div class="result">', "</div></div>"),
    "li": ("<li>", "</li>"),
    "div": ("<div>", "</div>"),
}


def synthetic_abebooks_page(seed: int, title: str = "The Sea", author: str = "John Banville",
                            year: str = "2005") -> str:
    """A seeded AbeBooks-like result page that reaches every selector and
    fallback of ``_parse_card``: card classes, or none (``li, div``); each
    title, link, author, price, currency, basket and date form; unclosed
    ``<li>`` and ``<p>``, nested cards, void and self-closed tags, comments,
    scripts, entities and odd whitespace."""
    import random

    rng = random.Random(seed)
    style = rng.choice(sorted(_CARD_OPEN))
    ws = lambda: rng.choice(["", " ", "\n", "\n\t  ", "  \r\n", "&#10;", "&nbsp;"])  # noqa: E731
    titles = [title, title.upper(), f"{title} (Vintage)", f"  {title}\n  Paperback  ", "Other Book",
              f"{title} &amp; Sky", title.replace(" ", "   ")]
    cards = []
    for i in range(rng.randint(2, 12)):
        t, parts = rng.choice(titles), []
        href = rng.choice([f"/servlet/BookDetailsPL?bi={1000 + i}", f"/bd{i}", f"https://www.abebooks.com/bd/{i}",
                           None])
        kind = rng.choice(["h2.srp-title", "span.srp-title", "link", "h2", "none"])
        if kind == "h2.srp-title":
            parts.append(f'<h2 class="srp-title">{t}</h2>')
        elif kind == "span.srp-title":
            parts.append(f'<span class="x srp-title">{t}</span>')
        elif kind == "h2":
            parts.append(f"<h2>{t}{rng.choice(['', '<br>', '<!-- ad -->'])}</h2>")
        if kind == "link" or (href and rng.random() < 0.5):
            cls = "srp-item-detail-link" if kind == "link" or rng.random() < 0.5 else "detail"
            parts.append(f'<a class="{cls}" href="{href or "/bd/x"}">{t if kind == "link" else "details"}</a>')
        elif href and "/bd" in href:
            parts.append(f'<a href="{href}">see{ws()}more</a>')
        if rng.random() < 0.7:
            cls = rng.choice(["author", "srp-author", "result-author", "text-muted"])
            parts.append(f'<span class="{cls}">{rng.choice([author, "by " + author, author.upper(), "Anon"])}</span>')
        price = rng.choice([
            '<meta itemprop="price" content="{a}">', '<span itemprop="price">US$&nbsp;{a}</span>',
            '<span itemprop="price" content="n/a">USD {a}</span>', '<p class="item-price">&pound;{a}',
            '<div class="srp-item-price">{a} EUR</div>', '<span class="price">C$ {a}</span>',
            '<b data-cy="listing-price">&euro;{c}</b>', '<b data-cy="item-price">AU$ {a}</b>',
            "<p>Price: USD {a}</p>", '<span class="price">Price on request</span>', "",
        ])
        amount = rng.choice(["8.50", "12.00", "4.75", "1,234.56", "19", "0.99"])
        parts.append(price.format(a=amount, c=amount.replace(".", ",")))
        if "itemprop" in price and rng.random() < 0.6:
            parts.append(rng.choice(['<meta itemprop="priceCurrency" content=" usd ">',
                                     '<span itemprop="priceCurrency" content="GBP"></span>',
                                     '<span itemprop="priceCurrency">EUR</span>']))
        if rng.random() < 0.3:
            cost = rng.choice(["4.75", "n/a", "", "12"])
            parts.append(f'<a id="add-to-basket-link-{i}" data-csa-c-cost="{cost}" '
                         f'data-csa-c-purchase-currency="{rng.choice(["US%24", "USD", "EUR"])}"></a>')
        y = rng.choice([year, year, "1978", "1999"])
        parts.append(rng.choice([
            f'<meta itemprop="datePublished" content="{y}">', f'<time itemprop="datePublished">{y}-01-02</time>',
            f'<span itemprop="datePublished" content=" {y} "></span>', f"<time>March {y}</time>",
            '<time content=""></time>', f"<span>Published: {y}</span>", f"<p>Publication date:{ws()}{y}",
            f"<span>First edition {y}</span>", "",
        ]))
        for _ in range(rng.randint(0, 2)):
            parts.insert(rng.randrange(len(parts) + 1), rng.choice([
                "<br>", "<br/>", '<img src="c.jpg" alt="cover">', "<hr>", '<input type="hidden" value="$3.00">',
                "<!-- sponsored $1.00 -->", '<script>var p = "$2.00";</script>', "<wbr>", "</span>", "<p>",
            ]))
        open_tag, close_tag = _CARD_OPEN[style]
        if style in ("srp", "li") and rng.random() < 0.3:
            close_tag = ""  # unclosed: the next card nests inside this one
        cards.append(open_tag + ws() + ws().join(parts) + ws() + close_tag)
    if rng.random() < 0.3:
        cards.append(cards[rng.randrange(len(cards))])  # a duplicate listing
    outer = ("<ul>", "</ul>") if style in ("srp", "li") else ("<div id=results>", "</div>")
    return ("<!DOCTYPE html><html><head><title>AbeBooks</title><style>.price{color:red}</style></head><body>"
            + outer[0] + "\n".join(cards) + outer[1] + "<footer>&copy; AbeBooks 2024</footer></body></html>")


PRICING_SEEDS = list(range(8))


def pricing_queries(title: str, author: str, year: str) -> list:
    """The (title, primary author, year) queries each page is parsed with."""
    return [dict(title=title, primary_author=author, year=None), dict(title=title, primary_author=None, year=year),
            dict(title=None, primary_author=None, year=None)]


def masked(obj, root: str = ""):
    """A service response with what differs between runs masked: values of
    ``transfer_key``, ``uptime_s``, ``ts`` and ``mtime``; in every string,
    ``root`` (the data directory) and millisecond timestamps."""
    if isinstance(obj, dict):
        return {k: "<masked>" if k in ("transfer_key", "uptime_s", "ts", "mtime") else masked(v, root)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [masked(v, root) for v in obj]
    if isinstance(obj, str):
        if root:
            obj = obj.replace(root, "<data>")
        return re.sub(r"\d{13}", "<ms>", obj)
    return obj


def pricing_flow(base: str, accepted: dict, root: str) -> dict:
    """The review and pricing requests of a scanner service: accept the
    metadata, take it back by its transfer key, look up offers (the four
    default providers), select the best, finalize approved and rejected
    (with the files written), the standalone aliases, the embed page and
    the processed list; each response masked (``masked``)."""
    import urllib.parse

    out = {}

    def call(name, method, path, payload=None):
        status, body = http_json(base, method, path, payload)
        out[name] = {"status": status, "body": masked(body, root)}
        return body

    saved = call("accept", "POST", "/api/accept", {"id": "Book 1 (ollama)", "metadata": accepted, "notes": "ok"})
    call("transfer_get", "GET", f"/api/transfer_get?key={saved['transfer_key']}")
    call("transfer_missing", "GET", "/api/transfer_get?key=bogus")
    query = {k: accepted.get(k) for k in ("title", "authors", "isbn_13", "isbn_10", "publisher")}
    query["publication_date"] = accepted.get("publication_date") or accepted.get("year")
    found = call("pricing_lookup", "POST", "/api/pricing_lookup", query)
    best = call("select_best", "POST", "/api/pricing/select_best", {"metadata": accepted, "offers": found["offers"]})
    for decision in ("approved", "rejected"):
        done = call(f"finalize_{decision}", "POST", "/api/pricing/finalize", {
            "id": "Book 1", "decision": decision, "merged": best["merged"], "best_offer": best["best_offer"],
            "comment": "priced" if decision == "approved" else "too cheap"})
        with open(done["path"], encoding="utf-8") as f:
            out[f"finalize_{decision}"]["file"] = json.load(f) if decision == "approved" else f.read()
    call("finalize_bad", "POST", "/api/pricing/finalize", {"decision": "maybe"})
    call("providers", "GET", "/api/pricing/providers")
    call("providers_alias", "GET", "/providers")
    call("lookup_alias", "POST", "/lookup", {"title": "Unlisted", "authors": "Nobody",
                                             "providers": ["abebooks", "google_books", "nope"]})
    call("embed", "GET", "/pricing_embed")
    call("processed_list", "GET", "/api/pricing/processed/list")
    call("processed_load", "GET", f"/processed/load?path={urllib.parse.quote(saved['path'])}")
    call("processed_refused", "GET", "/processed/load?path=/etc/passwd")
    return out


def pricing_reference() -> dict:
    """The JAX package's pricing outputs on canned clients and pages:
    ``parse_results_html`` of the recorded page of ``tests/test_pricing.py``
    and of seeded synthetic pages, then the JAX service's review and pricing
    requests (``pricing_flow``) on the ollama job's metadata of
    ``tests/data/server_route_jax_f32.json``, and the pricing CLI
    (``--from-json`` of the accepted JSON, ``--select``)."""
    import contextlib
    import io
    import tempfile

    import httpx

    from bbocr_tpu.cli import pricing as jax_pricing_cli
    from bbocr_tpu.pricing.providers.abebooks_html import parse_results_html
    from bbocr_tpu.server.app import ScannerService
    from tests.test_google_books import RECORDED
    from tests.test_pricing import ABEBOOKS_HTML

    with open(os.path.join(ROOT, "tests", "data", "server_route_jax_f32.json")) as f:
        accepted = json.load(f)["runs"]["ollama"]["1"]["meta"]
    title, author, year = accepted["title"], accepted["authors"][0], accepted["year"]
    pages = {"recorded": ABEBOOKS_HTML}
    pages.update({f"synthetic_{s}": synthetic_abebooks_page(s) for s in PRICING_SEEDS})
    pages["lookup"] = synthetic_abebooks_page(100, title, author, year)
    parses = []
    for name, page in pages.items():
        queries = (pricing_queries("The Sea", "John Banville", "2005") if name != "lookup"
                   else pricing_queries(title, author, year))
        for q in queries:
            parses.append({"page": name, "query": q, "offers": parse_results_html(page, **q)})
    lookup_pages = {" ".join((title, author, year)): "lookup"}
    http = CannedHttp(RECORDED, {kn: pages[name] for kn, name in lookup_pages.items()})
    original = httpx.AsyncClient
    httpx.AsyncClient = http
    try:
        with tempfile.TemporaryDirectory() as tmp:
            service = ScannerService(data_dir=tmp, books_dir=os.path.join(ROOT, "books"))
            with ServiceThread(service) as srv:
                flow = pricing_flow(srv.base, accepted, tmp)
            printed = io.StringIO()
            argv = sys.argv
            sys.argv = ["pricing", "--from-json", os.path.join(service.accepted_dir, "book_1_ollama.json"), "--select"]
            try:
                with contextlib.redirect_stdout(printed):
                    jax_pricing_cli.main()
            finally:
                sys.argv = argv
    finally:
        httpx.AsyncClient = original
    print(f"{len(parses)} parses; lookup offers {len(flow['pricing_lookup']['body']['offers'])}, errors "
          f"{flow['pricing_lookup']['body']['errors']}; best {flow['select_best']['body']['reason']}")
    return {"google_payload": RECORDED, "pages": pages, "lookup_pages": lookup_pages, "accepted": accepted,
            "parses": parses, "service": flow, "cli": json.loads(printed.getvalue()),
            "requests": sorted(http.requests, key=json.dumps)}


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
    mode.add_argument("--server-route", action="store_true")
    mode.add_argument("--pricing", action="store_true")
    p.add_argument("--canvas", default=None,
                   help="HxW: one canvas instead of the menu (--default-route, --autocrop, --engine-options, "
                        "--evaluate-real, --evaluate-books, --server-route)")
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
    elif args.server_route:
        out = server_route(canvas)
        out_path = args.out or os.path.join(data, f"server_route_jax_f32{tail}.json")
    elif args.pricing:
        out = pricing_reference()
        out_path = args.out or os.path.join(data, "pricing_jax.json")
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
