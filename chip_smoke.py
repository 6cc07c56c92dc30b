#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``bbocr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
``g++``. It:

1. prints the card's name and power limit;
2. builds the CUDA kernels (nvcc), the C++ labeler and the C++ JPEG
   decoder and encoder (g++) in parallel from the sources in the checkout, and prints
   the build seconds;
3. holds each kernel bit-exact against its plain PyTorch version on the
   card at nine shapes (the slice's (1, 1312, 1050) from the chain itself,
   random images at 70x90 (N=2), 33x41, 1x1, 2x3, 3x8, 7x5 (N=2),
   1313x1051 and 64x4099), and times each kernel at the slice's shape:
   ``ms`` and ``plain_ms`` are the median of 20 single calls between CUDA
   events (launch included), ``device_ms`` the kernel's own device time from
   torch.profiler with a warm L2, ``device_ms_l2_flushed`` the same with a
   64 MB write between calls; it also times the contrast mean
   (``rounded_mean``) against the int64 sum it replaced;
4. turns ``data/real/covers/book1.png`` into metadata JSON through the
   port's extractor on the card (bfloat16 engine with device warps,
   extractor defaults: ``auto_rotate`` resolves to the rotation route for
   this photo, as in the JAX package, then both re-reads; the chosen k and the four rotation scores are
   printed, and k must be the JAX package's, recorded in
   ``tests/data/book1_rotations_jax_bf16.json``), with every kernel launch
   count set to 0 just before and read just after: each kernel must have
   run; then profiles one warm photo with torch.profiler and prints the
   top device ops, the device's idle share over the call and the LSTM
   scan's host ms, device ms and kernel launches; replays the photo's LSTM calls through the scan and through
   cuDNN's ``nn.LSTM`` (timed, not used) and compares the card's scan with
   the CPU's on the same inputs; times the photo's GroupNorm calls in
   three forms (bfloat16 parameters, float32 input and parameters,
   bfloat16 input with float32 parameters); and holds the upright bfloat16
   reading against the JAX package's, recorded in
   ``tests/data/book1_jax_bf16.json``: the same box count, each box's text
   and quad distance printed;
5. reads the same photo in float32 (cuDNN TF32 off) with the kernels and
   with their plain versions: the preprocessed images and the box texts
   must be identical;
6. holds that float32 reading against the JAX package's, recorded in
   ``tests/data/book1_jax_f32.json``: the same texts, quads within 1 px;
7. a camera photo: the port's JPEG decoder must reproduce the SHA-256 of
   Pillow's decoding of every repository JPEG
   (``tests/data/jpeg_pillow_sha256.json``); then
   ``data/real/photos/3/IMG_9687.jpg`` goes JPEG -> preprocessing -> PIL
   BILINEAR downscale -> rotation route -> JSON through the extractor, in
   float32 (TF32 off) held to the JAX package's reading
   (``tests/data/IMG_9687_rotations_jax_f32.json``: the same k, box count
   and texts, quads within 1 px), and in bfloat16 (the same k; text
   differences printed);
8. the default route: ``BookMetadataExtractor(llm_backend="heuristic")``
   with its defaults (host crop rectification by the C++ warp, rotations
   for camera-shaped photos, the single-dispatch fast path for small
   upright ones, then the low-confidence re-read with the device prefix
   beam and the digit-biased ISBN re-read) on the five covers and
   ``IMG_9687.jpg``, with every kernel launch count set to 0 just before
   and read just after. In float32 (TF32 off) each photo's JSON must equal
   the JAX package's default-route JSON
   (``tests/data/default_route_jax_f32.json``); per photo the route, the
   chosen k, the boxes the re-read replaced and the ISBN are printed beside
   JAX's. In bfloat16 (an unwrapped engine of the default configuration,
   as the reference was recorded) the differences from
   ``default_route_jax_bf16.json`` are printed. The card's device beam on every recorded re-read batch must
   give the CPU's ids, and the card's labels on every fast-path mask the
   CPU's. Then it times the beam loop (host ms, device ms, kernel launches
   per re-read batch), the host warp (ms per crop), prints the labeling's
   step counts, times the fast path against ``readtext`` on ``book2.png``
   and ``book4.png``, and a default-route photo's first call and warm call;
9. this slice's paths, in float32 (TF32 off) unless said otherwise, every
   check failing the run: (a) ``BookMetadataExtractor(llm_backend=
   "heuristic")`` built with no engine takes the process-wide shared engine
   wrapped in ``BatchingOCR`` (its ``from_checkpoint`` given a float32
   configuration for the run), with every kernel launch count set to 0 just
   before and read just after; on the five covers and the camera photo each
   JSON, route and k must equal the JAX package's
   (``tests/data/shared_engine_route_jax_f32.json``); (b) 6 threads each
   submit the six photos' OCR inputs to that batcher: fewer batches than
   requests, and each result equal to one ``readtext_batch`` call on the
   batch it was coalesced into; (c) ``readtext_stream`` over the covers and
   the repository's JPEGs in batches of 8 (the default bfloat16 engine, as
   ``bench.py`` runs it), with the engine's host stages in serial loops and
   on its host pool, in the order A B B A: each batch equal to
   ``readtext_batch``, photos per second and stage times printed, after the
   numpy letterbox resize timed in a loop and on the pool; (d) ``warmup``: its calls and seconds,
   and a photo's first call with and without it, each in a fresh process
   (``python3 chip_smoke.py --warmup-probe with|without``); (e) auto-crop:
   the rectangles of the six preprocessed photos and the ``crop_for_ocr=True``
   extractor's JSON and routes must equal the JAX package's
   (``tests/data/autocrop_jax_f32.json``), kernel launches counted over that
   route, ``text_mask``'s time at a cover's size; (f) ``book1.png`` read with
   ``wire_bits`` 4 and 2, ``detect_pool=2``, ``detect_coarse=2`` and
   ``fold_gray_stem=False``: texts equal to the JAX package's and quads
   within 1 px (``tests/data/engine_options_jax_f32.json``), the letterbox
   and detect stages' ms against the default;
10. the evaluation CLIs and the detector layouts, every check failing the
   run: (a) ``cli.evaluate_real.evaluate_real`` over the 21 books of
   ``data/real/`` in float32 (TF32 off): each book's rotations and texts
   equal the JAX package's (``tests/data/evaluate_real_jax_f32.json``),
   confidences within 1e-3, and the corpus word recall, phrase CER and
   per-field accuracy equal, but for the one pinned reading
   (``KNOWN_READINGS``), whose map pixel the card must reproduce against
   ``tests/data/threshold_witness_jax_f32.json``; then with the default bfloat16 engine, its
   corpus scores printed beside the JAX package's bfloat16 run
   (``evaluate_real_jax_bf16.json``); (b) ``cli.evaluate.evaluate_books``
   over the 25 books of ``books/`` through the no-engine extractor, its
   shared engine given a float32 configuration, with every kernel launch
   count set to 0 just before and read just after: each book's fields equal
   the JAX package's (``evaluate_books_jax_f32.json``) and each kernel
   launched; then in bfloat16, no book raising, the per-field accuracy
   beside the JAX package's (``evaluate_books_jax_bf16.json``); (c) engines of the
   ``CRAFTLite`` and ``CRAFTPublished`` layouts from seeded variables of
   the flax shapes in ``tests/data/layouts_jax_shapes.json``: the card's
   float32 score maps at the full canvas (1408x1024) against the same
   engine's on the CPU, within 1e-3 of their largest magnitude, then one
   ``readtext`` each with the detect stage's time beside the default
   CRAFT's;
11. the LLM backends, the encoders and the host CLIs, every check failing
   the run: (a) the model inputs' JPEGs (``_encode_jpeg_b64`` at 2000 px,
   quality 88 and 3200 px, quality 95) and the trace's PNG previews
   (800 px) of the photos of ``books/1`` to ``books/3``, two camera
   photos, ``book1.png`` and book1 as the port's chain preprocesses it on
   the CPU (``tests/data/book1_preprocessed_port_f32.png``; the card's own
   preprocessed book1 and its JPEGs are compared and printed), each input's
   and output's SHA-256 equal to what the JAX extractor's Pillow calls give
   (``tests/data/encode_jax_sha256.json``), ms per encode printed; (b) the
   no-engine extractor on ``books/1`` to ``books/3`` for the ``ollama``,
   ``openai`` and ``gemini`` backends through a fake HTTP session with the
   reference's canned replies (fenced JSON, echoed placeholders, a Gemini
   404 then its renamed model), ``capture_trace=True``, its shared engine
   given a float32 configuration, every kernel launch count set to 0 just
   before and read just after: each request's prompt, URL, headers,
   timeout and body, the cover's JPEG, the metadata and the trace's steps
   equal the JAX package's CPU run (``tests/data/llm_route_jax_f32.json``);
   the OCR'd photos' JPEG digests printed beside JAX's, then the bfloat16
   run's differences; any exception in an LLM call fails the run; (c)
   ``process_book --llm-backend ollama`` with the canned session writes its
   JSON, ``batch --llm-backend heuristic`` over three books with 1 and 2
   workers in float32 (all succeed, fields equal), ``smoke --books-dir books`` prints
   ``SMOKE PASS``, ``profile_engine --photos 4 --repeat 2`` prints its
   stage times;
12. the scanner service (``bbocr_tpu_torch/server/app.py``) on the card,
   served on 127.0.0.1 in a thread with its own event loop and driven with
   the standard library's HTTP client only, every check failing the run:
   its engine warm-up at startup (``BB_OCR_ENGINE_WARMUP=1``, the shared
   engine given a float32 configuration) must run to its end; the photos of
   ``books/1`` to ``books/3`` posted to ``/api/process_images`` with
   ``run_ocr=true`` for the ``heuristic`` and ``ollama`` backends (the
   canned session of phase 11b), each job followed on ``/api/job_stream``
   and ``/api/trace_stream`` until it ends, then read on ``/api/job_result``,
   ``/api/trace_poll`` and ``/api/log_poll``, with every kernel launch count
   set to 0 just before and read just after (2 per job): each job's
   metadata, trace steps and LLM request equal to the JAX service's float32
   CPU run (``tests/data/server_route_jax_f32.json``), no job in ``error``,
   no ``OCR failed:`` in any log; seconds per job, the time from posting to
   the first trace frame and the log's lines printed; then ``/api/accept``
   on the ollama job's metadata, ``/api/transfer_get``,
   ``/api/pricing_lookup`` through canned Google Books and AbeBooks clients,
   ``/api/pricing/select_best``, ``/api/pricing/finalize`` both ways with
   the files written, the ``/providers``, ``/lookup`` and
   ``/pricing_embed`` aliases, and ``cli.pricing --from-json <accepted>
   --select``, all equal to the JAX outputs in
   ``tests/data/pricing_jax.json`` (times, ids and paths masked), as is the
   stdlib AbeBooks parser on every recorded page (there is no bs4 here).
   While a job runs the service sends every print of the process into the
   job's log, so the phase prints after the service has shut down;
13. the PageReader (``models/vlm.py``, ``llm/native_vlm.py``) on the shipped
   ``checkpoints/vlm.npz``, on the 24 pages of ``tests/data/vlm_jax_f32.json``
   (the first image of every book ``vlm_eval --real`` scores and the covers
   of ``books/1`` to ``books/3``, each loaded as the client loads a page):
   (a) in float32 (TF32 off) each greedy reading must equal the JAX
   package's float32 CPU run, or be a pinned reading (``KNOWN_VLM_READINGS``)
   whose JAX top-2 logit margin at the first differing step is below 1e-4;
   the teacher-forced logits on JAX's ids are printed against JAX's; (b)
   and (d) in bfloat16, the client's type: ``vlm_eval --real`` on the card
   reads the first 21 pages, the three covers are read directly, each
   page's token agreement with the JAX package's bfloat16 CPU run and the
   largest logit difference of a teacher-forced pass printed, then the
   report beside JAX's (``vlm_jax_bf16.json``; the same books and fields
   required); (c) the no-engine extractor with ``llm_backend="tpu"`` on
   ``books/1`` to ``books/3`` and one service job (``llm_backend=tpu``,
   ``model=checkpoints/vlm.npz``), the cached client's model a float32
   PageReader and the shared engine float32: metadata equal to the JAX
   extractor's recorded run, each kernel launched once per OCR'd photo
   (launch counts set to 0 just before and read just after), then one
   book timed with the default bfloat16 model; (e) the encoder's ms, the
   decode's first and warm seconds, and one warm decode's host ms, device
   ms and kernels from torch.profiler.
14. training (``train/``, ``cli/train.py``; no kernel lies on this path, and
   launch counts over 14a and 14b are printed and must stay 0): (a) the
   three step makers (CRNN, CRAFT, the PageReader with its CTC auxiliary
   loss at weight 0.5) in float32 with TF32 off at full width from the
   shipped checkpoints on the batches the JAX generators recorded
   (``tests/data/train_batches.npz``), three steps each, held to the JAX
   package's float32 CPU run (``tests/data/train_jax_f32.json``, ``.npz``):
   losses and the step-1 gradient norm within 1e-4 relative, 128 recorded
   elements per parameter leaf within 1e-4 after step 3 but where a step-1
   gradient is below 1e-6 or the two step-1 gradients differ in sign
   (Adam's first move takes its sign from rounding there; both counted);
   (b) the same in bfloat16, each loss finite and within 0.02 of the JAX
   package's bfloat16 CPU run (``train_jax_bf16.json``); (d) one bfloat16
   step of each: seconds, host ms, device ms and kernels (torch.profiler),
   peak memory, crops or pages per second; (c) the CLI's recognizer loop on
   the recorded batch: 2 steps with ``--state-dir``, a resume to step 4, the
   saved ``crnn.npz`` read by ``OCREngine.from_checkpoint`` through the
   extractor on ``book1.png`` (each kernel launched), and
   ``OCREngine.create()`` reading the same photo.
15. the data CLIs: (a) ``harvest_real_crops``'s loop over
   ``data/real/`` (21 books, 29 photos) with a float32 engine (TF32 off),
   held to the JAX package's float32 CPU harvest
   (``tests/data/harvest_jax_f32.json``, crops in ``_crops.npz``): the same
   crop names, labels, decodes and alignments, confidences within 1e-3,
   crop pixels within 1; the one box where the two float32 harvests can
   part (``covers/book5``, ``HARVEST_WITNESS``) follows the side the
   card's map takes; then ``harvest()`` once as shipped (bfloat16), its
   counts and seconds printed; (b) ``make_pipeline_crops``'s harvest of the
   four 704x512 pages the JAX ``PageGenerator(seed=0)`` drew
   (``tests/data/pipeline_pages.npz``) against ``pipeline_jax_f32.json``;
   (c) one read under ``utils/profiling.py::device_trace`` (its Chrome
   trace must name a CUDA kernel), ``cli/smoke.py`` without ``--books-dir``
   (``ImportError`` naming Pillow where Pillow is missing,
   ``FileNotFoundError`` naming a DejaVu font where only that is, else a
   passing run), ``__version__``.
16. multi-device (``parallel/``) on a 1x1 mesh of one NCCL rank
   (``single_device_mesh()``), bit for bit in float32 against the
   unsharded path: the mesh engine's ``readtext_batch`` over the five
   covers, ``BookMetadataExtractor`` given the mesh engine over
   ``books/1`` to ``books/3`` (each kernel's launches counted, the
   ``launches_mesh_route`` column), one joint step and one CRNN step on the
   recorded batches; then the group is destroyed;
17. the routed experts' grouped GEMM (``csrc/moe_gemm.cu``, built into its
   own library) at Moonlight-16B-A3B's widths (64 experts of 1408, hidden
   2048, 6 a token; ``portbench/configs/moonlight_16b_a3b.json``) in
   bfloat16, at a decode step of 128 rows and at one prefill chunk
   (``mla_moe.FFN_CHUNK`` tokens): against ``routed_experts_plain`` on the
   same inputs (within one bfloat16 step of the output's scale, the share
   of bit-equal values printed), then ``ms`` and ``library_ms`` (the
   per-expert loop of cuBLAS GEMMs) per call, and each kernel's device ms
   (warm and L2-flushed) beside its bound from the inputs (FLOPs at 989
   TFLOP/s, or the touched experts' weights and the rows in and out at
   3.35 TB/s);
   then the whole model from the configuration with random weights, one
   ``mla_moe.generate`` of 8 prompts and 16 new tokens with the launches
   counted from 0 (the first call captures the step), and a second call
   under the profiler, whose ``bbocr_moe_`` kernels are counted and timed
   by tiling beside their bound. ``python3 chip_smoke.py --moe`` runs
   phases 1 and 17 alone.

Phases 4 to 7 run the engine of the first slices (device warps from the
canvas, greedy decode), as their references were recorded; phases 8 and 9
run the defaults.

Any failed check exits non-zero, and so does any exception that the
extractor caught, as the JAX extractor does, from an image's OCR or a
re-read (``watch_swallowed``): the run fails at the next phase. The line before the last is one JSON
object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bbocr_tpu_torch import kernels
from bbocr_tpu_torch.extract import BookMetadataExtractor, validate_metadata, validate_schema
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.kernels import build as kernel_build
from bbocr_tpu_torch.models import crnn as crnn_module
from bbocr_tpu_torch.native import jpeg as native_jpeg
from bbocr_tpu_torch.native import loader as native_loader
from bbocr_tpu_torch.ops import rounded_mean
from bbocr_tpu_torch.preprocess.chain import KERNEL_OPS, PLAIN_OPS, _preprocess
from bbocr_tpu_torch.runtime import EngineConfig, OCREngine, orient
from bbocr_tpu_torch.runtime import engine as engine_module
from bbocr_tpu_torch.runtime import fastpath as fastpath_module

ROOT = os.path.dirname(os.path.abspath(__file__))
BOOK1 = os.path.join(ROOT, "data", "real", "covers", "book1.png")
CKPT = os.path.join(ROOT, "checkpoints")
# The JAX package's float32 and bfloat16 readings of book1.png on the CPU
# (scripts/torch_port_reference.py)
REFERENCE = os.path.join(ROOT, "tests", "data", "book1_jax_f32.json")
REFERENCE_BF16 = os.path.join(ROOT, "tests", "data", "book1_jax_bf16.json")
# A sideways camera photo, the JAX package's float32 rotation-route reading of
# it, and the digests of Pillow's decoding of every repository JPEG
# (scripts/torch_port_reference.py --rotations / --jpeg-digests)
CAMERA = os.path.join(ROOT, "data", "real", "photos", "3", "IMG_9687.jpg")
CAMERA_REFERENCE = os.path.join(ROOT, "tests", "data", "IMG_9687_rotations_jax_f32.json")
BOOK1_ROTATIONS = os.path.join(ROOT, "tests", "data", "book1_rotations_jax_bf16.json")
JPEG_DIGESTS = os.path.join(ROOT, "tests", "data", "jpeg_pillow_sha256.json")
# The JAX package's default-route JSON and routes, float32 and bfloat16
# (scripts/torch_port_reference.py --default-route [--dtype bfloat16])
DEFAULT_ROUTE = os.path.join(ROOT, "tests", "data", "default_route_jax_f32.json")
DEFAULT_ROUTE_BF16 = os.path.join(ROOT, "tests", "data", "default_route_jax_bf16.json")
# The JAX package's no-engine extractor through its BatchingOCR-wrapped shared
# engine, its auto-crop rectangles and crop_for_ocr JSON, and its readings of
# book1.png under each engine option, all float32 (scripts/torch_port_reference.py
# --shared-engine-route / --autocrop / --engine-options)
SHARED_ROUTE = os.path.join(ROOT, "tests", "data", "shared_engine_route_jax_f32.json")
AUTOCROP = os.path.join(ROOT, "tests", "data", "autocrop_jax_f32.json")
ENGINE_OPTIONS = os.path.join(ROOT, "tests", "data", "engine_options_jax_f32.json")
# The JAX package's evaluate_real over data/real/ and evaluate_books over
# books/, float32 and bfloat16, and the flax shapes of the lite and published
# detector layouts (scripts/torch_port_reference.py --evaluate-real /
# --evaluate-books [--dtype bfloat16] / --layouts)
REAL_DIR = os.path.join(ROOT, "data", "real")
BOOKS_DIR = os.path.join(ROOT, "books")
EVAL_REAL = os.path.join(ROOT, "tests", "data", "evaluate_real_jax_f32.json")
EVAL_REAL_BF16 = os.path.join(ROOT, "tests", "data", "evaluate_real_jax_bf16.json")
EVAL_BOOKS = os.path.join(ROOT, "tests", "data", "evaluate_books_jax_f32.json")
EVAL_BOOKS_BF16 = os.path.join(ROOT, "tests", "data", "evaluate_books_jax_bf16.json")
LAYOUTS = os.path.join(ROOT, "tests", "data", "layouts_jax_shapes.json")
# Both packages' float32 score maps on the CPU where their evaluate_real
# readings differ (scripts/torch_port_reference.py --threshold-witness)
WITNESS = os.path.join(ROOT, "tests", "data", "threshold_witness_jax_f32.json")
# What the JAX extractor's Pillow calls make of fixed inputs, and its LLM route
# on books/1 to books/3 through canned replies, float32
# (scripts/torch_port_reference.py --encode / --llm-route)
ENCODE_REFERENCE = os.path.join(ROOT, "tests", "data", "encode_jax_sha256.json")
LLM_ROUTE = os.path.join(ROOT, "tests", "data", "llm_route_jax_f32.json")
# The JAX scanner service's jobs on books/1 to books/3 (heuristic, ollama through
# the canned session), float32, and the JAX pricing outputs on canned clients
# and pages (scripts/torch_port_reference.py --server-route / --pricing)
SERVER_ROUTE = os.path.join(ROOT, "tests", "data", "server_route_jax_f32.json")
PRICING_REFERENCE = os.path.join(ROOT, "tests", "data", "pricing_jax.json")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12  # H100 SXM bfloat16 tensor-core peak, dense
F32_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores
SOURCE = "bbocr_tpu_torch/csrc/preprocess.cu"
PALLAS = "bbocr_tpu/kernels/preprocess_pallas.py"
# name -> (TPU kernel it replaces, float operations per pixel, CUDA symbol)
KERNEL_INFO = {
    "blur3_u8": (f"{PALLAS}:137", 2 * 2 * 3 + 3, "sepconv_u8_kernel"),
    "enhance_u8": (f"{PALLAS}:169", 10, "enhance_u8_kernel"),
    "unsharp_u8": (f"{PALLAS}:143", 2 * 2 * 7 + 12, "sepconv_u8_kernel"),
}
TIMING_REPS = 20
LSTM_MARK = "bbocr::lstm_scan"
L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2


def seeded_variables(shapes: dict, seed: int) -> dict:
    """Random variables for a tree of leaf shapes in the flax layout (lists
    of ints, as ``jax.eval_shape`` of a model's ``init`` gives them), from
    ``np.random.default_rng(seed)`` in sorted key order. Scaled so that a
    deep stack of them stays in range: conv and dense kernels normal with
    variance 2 / fan-in, LSTM matrices with 1 / fan-in, normalisation scales
    near 1, biases and running means near 0, running variances in
    [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def make(name: str, shape) -> np.ndarray:
        shape = tuple(shape)
        if name == "kernel":
            values = rng.standard_normal(shape) * math.sqrt(2.0 / math.prod(shape[:-1]))
        elif name in ("w_ih", "w_hh"):
            values = rng.standard_normal(shape) / math.sqrt(shape[0])
        elif name == "scale":
            values = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            values = rng.uniform(0.5, 1.5, shape)
        else:  # bias, b_ih, mean
            values = 0.1 * rng.standard_normal(shape)
        return values.astype(np.float32)

    def walk(node: dict) -> dict:
        return {k: walk(v) if isinstance(v, dict) else make(k, v) for k, v in sorted(node.items())}

    return walk(shapes)


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# Exceptions that the extractor's handlers, copied from the JAX extractor,
# turn into an ``OCR failed`` line and no text, the first reading or no ISBN.
SWALLOWED: list = []


def _recorded(name: str, fn):
    def call(*args, **kw):
        try:
            return fn(*args, **kw)
        except Exception as e:
            SWALLOWED.append(f"{name}: {e!r}")
            raise

    return call


def watch_swallowed() -> None:
    """Wraps the three calls whose exceptions the extractor carries on
    from, so that each is recorded before it propagates and the run fails
    on it at the next phase (``phase``), although the extractor returns."""
    for cls, name in ((BookMetadataExtractor, "_ocr_text"), (OCREngine, "reread_low_conf"),
                      (OCREngine, "reread_isbn")):
        setattr(cls, name, _recorded(name, getattr(cls, name)))


def phase(title: str) -> None:
    """Fails the run if the extractor swallowed an exception since the
    last phase began, then logs the start of the next one."""
    if SWALLOWED:
        fail(f"{len(SWALLOWED)} exceptions were caught by the extractor's handlers before \"{title}\": "
             f"{SWALLOWED[:5]}")
    log(title)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_report(build_log: str) -> list:
    """One line per kernel instantiation from ``nvcc -Xptxas -v``:
    registers, shared memory and spills."""
    lines, name, spill = [], None, ""
    for line in build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            args = re.search(r"(sepconv_u8_kernel)ILi(\d+)ELi(\d+)ELi(\d+)E", mangled)
            name = f"{args.group(1)}<R={args.group(2)},border={args.group(3)},epilogue={args.group(4)}>" if args else (
                "enhance_u8_kernel" if "enhance_u8_kernel" in mangled else mangled)
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return lines


def build_all() -> float:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = [pool.submit(kernel_build.build), pool.submit(native_loader.build), pool.submit(native_jpeg.build),
                   pool.submit(native_jpeg.build_encoder)]
        for f in futures:
            f.result()
    kernel_build.load()
    native_loader.load()
    native_jpeg.load()
    native_jpeg.load_encoder()
    seconds = time.perf_counter() - t0
    for line in ptxas_report(kernel_build.build_log):
        print(f"  ptxas: {line}", flush=True)
    return seconds


def median_ms(fn, reps: int = TIMING_REPS) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled_device_ms(fn, symbol: str, reps: int = TIMING_REPS, flush: bool = False):
    """Device time per call of the kernels whose name holds ``symbol``, from
    torch.profiler's CUDA trace; None when the trace has no such kernel.
    ``flush``: write 64 MB between calls, so each finds its input out of L2."""
    from torch.profiler import ProfilerActivity, profile

    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if flush else None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush:
                scratch.fill_(1.0)
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages() if symbol in e.key)
    return total_us / 1e3 / reps if total_us > 0 else None


def chain_inputs(rgb: np.ndarray, dev) -> dict:
    """The three kernels' arguments as the slice's chain gives them for
    book1, recorded from the chain itself running the plain versions."""
    seen = {}

    def recorder(name, fn):
        def record(*args):
            seen[name] = args
            return fn(*args)
        return record

    _preprocess(rgb, 1.5, dev, tuple(recorder(n, fn) for n, fn in zip(("blur3_u8", "enhance_u8", "unsharp_u8"), PLAIN_OPS)))
    return seen


def random_inputs(n: int, h: int, w: int, seed: int, dev) -> dict:
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 256, (n, h, w)).astype(np.float32)).to(dev)
    return {"blur3_u8": (x,), "enhance_u8": (x, rounded_mean(x), 1.9, 1.2), "unsharp_u8": (x,)}


def call(name: str, args, plain: bool):
    fn = getattr(kernels, f"{name}_plain") if plain else kernels.KERNELS[name]
    return fn(*args)


def rounded_mean_int64(img: torch.Tensor) -> torch.Tensor:
    """The contrast mean as it was first taken: an int64 copy of the image, summed."""
    total = img.to(torch.int64).sum(dim=(-2, -1))
    return torch.floor(total.to(torch.float64) / (img.shape[-2] * img.shape[-1]) + 0.5).to(torch.float32)


def time_rounded_mean(x: torch.Tensor) -> None:
    if not torch.equal(rounded_mean(x), rounded_mean_int64(x)):
        fail("rounded_mean differs from the int64 sum")
    # in turns: before, after, after, before
    times = {"int64": [], "float": []}
    for which in ("int64", "float", "float", "int64"):
        fn = (lambda: rounded_mean_int64(x)) if which == "int64" else (lambda: rounded_mean(x))  # noqa: E731
        times[which].append(median_ms(fn))
        times[which].append(profiled_device_ms(fn, ""))
    show = {k: " / ".join("not measured" if t is None else f"{t:.5f}" for t in v) for k, v in times.items()}
    print(f"rounded_mean at {tuple(x.shape)} (per call ms / device ms, twice each): "
          f"int64 sum {show['int64']}; float32 rows + float64 total {show['float']}", flush=True)


def check_kernels(rgb: np.ndarray, dev) -> dict:
    """Bit-exactness at nine shapes; timings at the slice's shape."""
    cases = [
        ("1x1312x1050", chain_inputs(rgb, dev)),
        ("2x70x90", random_inputs(2, 70, 90, 0, dev)),
        ("1x33x41", random_inputs(1, 33, 41, 1, dev)),
        ("1x1x1", random_inputs(1, 1, 1, 2, dev)),
        ("1x2x3", random_inputs(1, 2, 3, 3, dev)),
        ("1x3x8", random_inputs(1, 3, 8, 4, dev)),
        ("2x7x5", random_inputs(2, 7, 5, 5, dev)),
        ("1x1313x1051", random_inputs(1, 1313, 1051, 6, dev)),
        ("1x64x4099", random_inputs(1, 64, 4099, 7, dev)),
    ]
    report = {}
    for name in kernels.KERNELS:
        worst = 0.0
        for label, inputs in cases:
            got = call(name, inputs[name], plain=False)
            ref = call(name, inputs[name], plain=True)
            torch.cuda.synchronize()
            if got.shape != ref.shape or not torch.isfinite(got).all():
                fail(f"{name} at {label}: shape {tuple(got.shape)} or non-finite values")
            err = float((got - ref).abs().max())
            worst = max(worst, err)
            if err != 0.0:
                fail(f"{name} at {label}: max abs diff {err} against the plain version (must be 0)")
        args = cases[0][1][name]
        n, h, w = args[0].shape
        bytes_moved = 2 * n * h * w * 4 + (n * 4 if name == "enhance_u8" else 0)
        ops = n * h * w * KERNEL_INFO[name][1]
        byte_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        op_ms = ops / F32_OPS_PER_S * 1e3
        kernel = lambda: call(name, args, plain=False)  # noqa: E731
        report[name] = {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": KERNEL_INFO[name][0],
            "max_abs_err": worst,
            "ms": median_ms(kernel),
            "plain_ms": median_ms(lambda: call(name, args, plain=True)),
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": None,
            "device_ms": profiled_device_ms(kernel, KERNEL_INFO[name][2]),
            "device_ms_l2_flushed": profiled_device_ms(kernel, KERNEL_INFO[name][2], flush=True),
        }
        r = report[name]
        shown = {k: "not measured" if r[k] is None else f"{r[k]:.5f} ms" for k in ("device_ms", "device_ms_l2_flushed")}
        log(f"{name}: bit-exact at {[c[0] for c in cases]}; at {n}x{h}x{w}: "
            f"{r['ms']:.5f} ms per call (plain {r['plain_ms']:.5f} ms), kernel device time "
            f"{shown['device_ms']} warm, {shown['device_ms_l2_flushed']} L2 flushed, bound {r['bound_ms']:.5f} ms")
    time_rounded_mean(cases[0][1]["enhance_u8"][0])
    return report


class ReadRecorder:
    """Records every ``readtext`` of an engine while in use, so that the
    rotation route's per-rotation scores and choice can be printed: k is
    the first rotation with the largest (``rotation_score``,
    ``_wordlike_mass``), as ``read_with_rotations`` takes it."""

    def __init__(self, engine):
        self.engine = engine
        self.reads, self.shapes = [], []

    def __enter__(self):
        readtext = self.engine.readtext

        def record(image):
            self.shapes.append(tuple(image.shape[:2]))
            self.reads.append(readtext(image))
            return self.reads[-1]

        self.engine.readtext = record
        return self

    def __exit__(self, *exc):
        del self.engine.readtext

    def choice(self):
        if len(self.reads) != 4:
            fail(f"the rotation route read {len(self.reads)} images, not 4")
        scores = [(orient.rotation_score(r), orient._wordlike_mass(r)) for r in self.reads]
        k = max(range(4), key=lambda i: (scores[i], -i))
        return k, scores, self.reads[k]


def default_engine(dev, dtype=torch.bfloat16, **config) -> OCREngine:
    """An unwrapped engine of the default configuration in ``dtype``."""
    return OCREngine.from_checkpoint(
        os.path.join(CKPT, "craft.npz"), os.path.join(CKPT, "crnn.npz"),
        EngineConfig(compute_dtype=dtype, **config), device=dev,
    )


def slice_engine(dev, dtype=torch.bfloat16) -> OCREngine:
    """The engine of phases 4 to 7: device warps from the canvas and greedy
    decode, the configuration their JAX references were recorded in."""
    return OCREngine.from_checkpoint(
        os.path.join(CKPT, "craft.npz"), os.path.join(CKPT, "crnn.npz"),
        EngineConfig(compute_dtype=dtype, host_rectify=False, decoder="greedy"), device=dev,
    )


def run_slice(dev):
    extractor = BookMetadataExtractor(llm_backend="heuristic", engine=slice_engine(dev), device=dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with ReadRecorder(extractor.engine) as rec:
        meta = extractor.extract_metadata_from_images([BOOK1], ocr_image_indices=[0])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.KERNELS.items()}
    k, scores, _ = rec.choice()
    with open(BOOK1_ROTATIONS) as f:
        ref = json.load(f)
    print(f"rotation route: read shapes {rec.shapes}; (rotation_score, wordlike_mass) per k {scores}; chosen k = {k}; "
          f"the JAX package's bfloat16 route: k = {ref['k']}, scores {ref['scores']}", flush=True)
    if k != ref["k"]:
        fail(f"the rotation route chose k = {k} for book1.png, the JAX package k = {ref['k']}")
    return meta, launches, seconds, extractor


def profile_warm_photo(extractor) -> None:
    """torch.profiler over one warm bfloat16 photo: the top device ops, the
    device's idle share over the call, and the time inside the LSTM."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    scan = crnn_module.bidirectional_scan

    def marked_scan(*args):
        with record_function(LSTM_MARK):
            return scan(*args)

    torch.cuda.synchronize()
    crnn_module.bidirectional_scan = marked_scan
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            extractor.extract_metadata_from_images([BOOK1], ocr_image_indices=[0])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        crnn_module.bidirectional_scan = scan
    events = prof.events()
    busy = sorted((e.time_range.start, e.time_range.end) for e in events if e.device_type == DeviceType.CUDA)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    span = (min(e.time_range.start for e in cpu), max(e.time_range.end for e in cpu)) if cpu else (0, 1)
    union, end = 0.0, None
    for a, b in busy:
        a, b = max(a, span[0]), min(b, span[1])
        if end is None or a > end:
            union += max(0.0, b - a)
            end = b
        elif b > end:
            union += b - end
            end = b
    length = span[1] - span[0]
    device_total = sum(b - a for a, b in busy)
    print(f"warm photo under the profiler: {wall_us / 1e3:.3f} ms wall; traced span {length / 1e3:.3f} ms; "
          f"device busy {union / 1e3:.3f} ms (kernel time {device_total / 1e3:.3f} ms); "
          f"device idle share {1 - union / length:.4f}", flush=True)
    # the scan's mark also shows as a device-side range spanning its kernels: not an op
    rows = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0 and e.key != LSTM_MARK),
                  key=lambda e: e.self_device_time_total, reverse=True)
    print("top device ops (self device ms, calls, name):", flush=True)
    for e in rows[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms  {e.count:5d}  {e.key[:110]}", flush=True)
    for e in prof.key_averages():
        if e.key in (LSTM_MARK, "aten::linear", "aten::conv2d") and e.cpu_time_total > 0:
            print(f"op {e.key}: {e.count} calls, {e.cpu_time_total / 1e3:.3f} ms host total, "
                  f"{e.device_time_total / 1e3:.3f} ms device total", flush=True)
    scans = [(e.time_range.start, e.time_range.end) for e in cpu if e.name == LSTM_MARK]
    launches = sum(1 for e in cpu if e.name.startswith("cudaLaunchKernel")
                   and any(a <= e.time_range.start <= b for a, b in scans))
    print(f"LSTM scan in the warm photo: {len(scans)} calls, "
          f"{launches if launches else 'not measured'} kernel launches", flush=True)


def time_lstm(engine: OCREngine, image: np.ndarray) -> None:
    """The LSTM calls of one bfloat16 read, replayed: the port's scan against
    cuDNN's ``nn.LSTM`` with the same weights (per photo: CUDA-event ms,
    profiler device ms, kernels launched), and the card's scan against the
    CPU's on the same inputs (the CPU's equals the JAX package's bit for
    bit, ``tests/test_torch_lstm.py``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = []
    layers = [engine.crnn.rnn0, engine.crnn.rnn1]
    hooks = [m.register_forward_pre_hook(lambda m, args: calls.append((m, args[0].detach().clone()))) for m in layers]
    try:
        engine.readtext(image)
    finally:
        for h in hooks:
            h.remove()
    cudnn = {}
    for m in layers:
        lstm = torch.nn.LSTM(m.fwd.w_ih.shape[0], m.fwd.w_hh.shape[0], batch_first=True, bidirectional=True)
        with torch.no_grad():
            for sfx, d in (("l0", m.fwd), ("l0_reverse", m.bwd)):
                getattr(lstm, f"weight_ih_{sfx}").copy_(d.w_ih.T)
                getattr(lstm, f"weight_hh_{sfx}").copy_(d.w_hh.T)
                getattr(lstm, f"bias_ih_{sfx}").copy_(d.b_ih)
                getattr(lstm, f"bias_hh_{sfx}").zero_()
        cudnn[m] = lstm.to(device=engine.device, dtype=m.fwd.w_ih.dtype)
        cudnn[m].flatten_parameters()
    forms = {
        "port scan": lambda m, x: crnn_module.bidirectional_scan(x, m.fwd, m.bwd),
        "cuDNN nn.LSTM (library, not used)": lambda m, x: cudnn[m](x)[0],
    }
    shapes = [tuple(x.shape) for _, x in calls]
    print(f"LSTM in one bfloat16 read: {len(calls)} BiLSTM calls on inputs {shapes}", flush=True)
    for name, form in forms.items():
        def photo(form=form):
            with torch.no_grad():
                for m, x in calls:
                    form(m, x)
        photo()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            photo()
            torch.cuda.synchronize()
        kernels_run = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        device = sum(e.time_range.end - e.time_range.start for e in kernels_run) / 1e3
        t0 = time.perf_counter()
        photo()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        print(f"  {name}: {median_ms(photo, reps=5):.4f} ms per photo (CUDA events), {host:.4f} ms host wall "
              f"(one call, synchronised), {device:.4f} ms device time, {len(kernels_run)} kernels", flush=True)
    worst, share = 0.0, 0.0
    with torch.no_grad():
        for m, x in calls:
            card = crnn_module.bidirectional_scan(x, m.fwd, m.bwd).float().cpu()
            on_cpu = copy.deepcopy(m).cpu()
            host_out = crnn_module.bidirectional_scan(x.cpu(), on_cpu.fwd, on_cpu.bwd).float()
            d = (card - host_out).abs()
            worst = max(worst, float(d.max()))
            share = max(share, float((d > 0).float().mean()))
    print(f"  card scan against the CPU scan (bfloat16, same inputs): max abs diff {worst:.6g}, "
          f"at most {share:.4%} of a call's values differ", flush=True)


def time_groupnorm(engine: OCREngine, image: np.ndarray) -> None:
    """Device time per photo of the GroupNorm calls of one bfloat16 read, in
    three forms on the same inputs: PR 4's (parameters rounded to
    bfloat16), the port's (input cast to float32, float32 parameters, one
    rounding) and a bfloat16 input with float32 parameters, which PyTorch's
    CUDA group_norm may refuse."""
    import torch.nn.functional as F

    calls = []
    norms = [m for model in (engine.craft, engine.crnn) for m in model.modules() if isinstance(m, torch.nn.GroupNorm)]
    hooks = [m.register_forward_pre_hook(lambda m, args: calls.append((m, args[0].detach().clone()))) for m in norms]
    try:
        engine.readtext(image)
    finally:
        for h in hooks:
            h.remove()
    low = {m: (m.weight.to(torch.bfloat16), m.bias.to(torch.bfloat16)) for m in norms}
    forms = {
        "bfloat16 parameters (PR 4)": lambda m, x: F.group_norm(x, m.num_groups, *low[m], m.eps),
        "float32 input and parameters, one rounding (PR 5)": lambda m, x: m(x),
        "bfloat16 input, float32 parameters": lambda m, x: F.group_norm(x, m.num_groups, m.weight, m.bias, m.eps),
    }
    print(f"GroupNorm in one bfloat16 read: {len(calls)} calls on "
          f"{sum(x.numel() for _, x in calls) * 2 / 1e6:.1f} MB of bfloat16 input", flush=True)
    for name, form in forms.items():
        def photo(form=form):
            with torch.no_grad():
                for m, x in calls:
                    form(m, x)
        try:
            photo()
        except RuntimeError as e:
            print(f"  {name}: refused by PyTorch {torch.__version__} on the card: {str(e).splitlines()[0]}", flush=True)
            continue
        device = profiled_device_ms(photo, "", reps=5)
        print(f"  {name}: {median_ms(photo, reps=5):.4f} ms per photo (CUDA events), "
              f"{'not measured' if device is None else f'{device:.4f} ms'} device time", flush=True)


def check_bf16_reading(res) -> None:
    """The card's default bfloat16 reading against the JAX package's on the
    CPU: the box count must be equal; each box's text and quad distance are
    printed. The two packages still round differently in the LSTM and sum
    convolutions in other orders (ROADMAP Queue 3), so texts and quads are
    recorded, not required (PERF.md, PR 5 review round)."""
    with open(REFERENCE_BF16) as f:
        ref = json.load(f)
    print(f"bfloat16 reading against the JAX package's: {len(res)} boxes, reference {len(ref['texts'])}", flush=True)
    if len(res) != len(ref["texts"]):
        fail(f"bfloat16 reading: {len(res)} boxes against {len(ref['texts'])} in the JAX reference")
    equal, worst = 0, 0.0
    for i, ((q, text, _), rq, rtext) in enumerate(zip(res, ref["quads"], ref["texts"])):
        err = float(np.abs(np.asarray(q) - np.asarray(rq)).max())
        equal, worst = equal + (text == rtext), max(worst, err)
        print(f"  box {i}: {text!r} (JAX {rtext!r}), quad within {err:.4f} px", flush=True)
    print(f"bfloat16 reading: {equal} of {len(res)} texts equal to the JAX reference, quads within {worst:.4f} px", flush=True)
    if len(res) > 3:
        print(f"bfloat16 box 3 reads {res[3][1]!r} on the card; the JAX package reads {ref['texts'][3]!r}", flush=True)


def check_jpeg_digests() -> None:
    """The port's decoder on every repository JPEG against the SHA-256 of
    Pillow's decoding, recorded where Pillow is installed."""
    with open(JPEG_DIGESTS) as f:
        digests = json.load(f)
    seconds = 0.0
    for rel, want in digests.items():
        t0 = time.perf_counter()
        rgb = load_rgb(os.path.join(ROOT, rel))
        seconds += time.perf_counter() - t0
        if list(rgb.shape) != want["shape"] or hashlib.sha256(rgb.tobytes()).hexdigest() != want["sha256"]:
            fail(f"{rel}: the port's JPEG decoding differs from Pillow's recorded digest")
    print(f"JPEG decoder: {len(digests)} repository JPEGs decode to Pillow's recorded SHA-256 digests; "
          f"{seconds:.3f} s in all (host, one thread)", flush=True)


def read_camera(engine: OCREngine, dev, label: str):
    """The camera photo through the extractor (rotation route); returns
    (chosen k, the chosen rotation's results)."""
    extractor = BookMetadataExtractor(
        llm_backend="heuristic", auto_rotate=None, reread_low_conf=False, isbn_reread=False,
        fast_single=None, warm_model=False, device=dev, engine=engine,
    )
    t0 = time.perf_counter()
    with ReadRecorder(engine) as rec:
        meta = extractor.extract_metadata_from_images([CAMERA], ocr_image_indices=[0])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    validate_schema(meta)
    k, scores, res = rec.choice()
    print(f"camera photo, {label}: {seconds:.3f} s; read shapes {rec.shapes}; scores per k {scores}; chosen k = {k}; "
          f"{len(res)} boxes; JSON {json.dumps({f: meta[f] for f in ('title', 'isbn_10', 'isbn_13')})}", flush=True)
    return k, res, rec.shapes[0]


def check_camera(dev, engine_f32: OCREngine, engine_bf16: OCREngine) -> None:
    with open(CAMERA_REFERENCE) as f:
        ref = json.load(f)
    k, res, shape = read_camera(engine_f32, dev, "float32")
    if list(shape) != ref["preprocessed_shape"]:
        fail(f"camera photo downscaled to {shape}, the JAX extractor to {ref['preprocessed_shape']}")
    if k != ref["k"]:
        fail(f"camera photo, float32: rotation k = {k}, the JAX package chose {ref['k']}")
    texts = [t for _, t, _ in res]
    if texts != ref["texts"]:
        fail(f"camera photo, float32: texts {texts} differ from the JAX reference {ref['texts']}")
    quad_err = max(float(np.abs(np.asarray(q) - np.asarray(rq)).max()) for (q, _, _), rq in zip(res, ref["quads"]))
    print(f"camera photo, float32: k = {k} and {len(texts)} boxes as in the JAX reference, texts equal, "
          f"quads within {quad_err:.4f} px", flush=True)
    if quad_err > 1.0:
        fail(f"camera photo, float32: quads differ from the JAX reference by {quad_err} px (limit 1)")
    k, res, _ = read_camera(engine_bf16, dev, "bfloat16")
    if k != ref["k"]:
        fail(f"camera photo, bfloat16: rotation k = {k}, the JAX package's float32 reading chose {ref['k']}")
    texts = [t for _, t, _ in res]
    ref_texts = ref["texts"]
    print(f"camera photo, bfloat16: k = {k}; {len(texts)} boxes against {len(ref_texts)} in the float32 JAX "
          f"reference; texts only here {sorted(set(texts) - set(ref_texts))}, only there "
          f"{sorted(set(ref_texts) - set(texts))}", flush=True)


class RouteRecorder:
    """Records, while in use, which route each photo takes through an
    engine: the reads (``readtext`` per rotation or ``readtext_fast``), the
    chosen rotation, the results the low-confidence re-read replaced and
    the ISBN re-read's answer (as scripts/torch_port_reference.py records
    the JAX package's)."""

    NAMES = ("readtext", "readtext_fast", "reread_low_conf", "reread_isbn")

    def __init__(self, engine):
        self.engine = engine

    def __enter__(self):
        e = self.engine
        self.reads, self.replaced, self.isbn, self.final = [], [], None, []
        orig = {n: getattr(e, n) for n in self.NAMES}

        def readtext(image):
            self.reads.append(("readtext", orig["readtext"](image)))
            return self.reads[-1][1]

        def readtext_fast(image):
            self.reads.append(("fast", orig["readtext_fast"](image)))
            return self.reads[-1][1]

        def reread_low_conf(image, results, **kw):
            out = orig["reread_low_conf"](image, results, **kw)
            self.replaced = [[i, a[1], b[1]] for i, (a, b) in enumerate(zip(results, out)) if a[1] != b[1]]
            self.final = out
            return out

        def reread_isbn(image, results):
            self.isbn = orig["reread_isbn"](image, results)
            return self.isbn

        for n, fn in zip(self.NAMES, (readtext, readtext_fast, reread_low_conf, reread_isbn)):
            setattr(e, n, fn)
        return self

    def __exit__(self, *exc):
        for n in self.NAMES:
            delattr(self.engine, n)

    def summary(self) -> dict:
        kinds = [kind for kind, _ in self.reads]
        if kinds == ["readtext"] * 4:
            scores = [(orient.rotation_score(r), orient._wordlike_mass(r)) for _, r in self.reads]
            k = max(range(4), key=lambda i: (scores[i], -i))
            route, chosen = "rotations", self.reads[k][1]
        else:
            k, route, chosen = None, "fast" if kinds == ["fast"] else "readtext", self.reads[-1][1]
        final = self.final or chosen
        return {"route": route, "k": k, "boxes": len(chosen), "replaced": self.replaced, "isbn": self.isbn,
                "texts": [t for _, t, _ in final]}


class Recording:
    """Replaces ``module.name`` with a wrapper that records each call's
    arguments (and, with ``keep_result``, its result) while in use."""

    def __init__(self, module, name, keep_result=False):
        self.module, self.name, self.keep_result = module, name, keep_result
        self.calls = []

    def __enter__(self):
        self.orig = fn = getattr(self.module, self.name)

        def wrapper(*args, **kw):
            out = fn(*args, **kw)
            self.calls.append((args, kw, out) if self.keep_result else (args, kw))
            return out

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def route_line(rel: str, got: dict, ref: dict) -> str:
    shown = {k: got[k] for k in ("route", "k", "boxes", "replaced", "isbn")}
    want = {k: ref[k] for k in ("route", "k", "boxes", "replaced", "isbn")}
    return f"  {rel}: {json.dumps(shown)}; JAX {json.dumps(want)}"


def run_default_route(extractor, photos, label: str, card: str) -> dict:
    """Each photo through the extractor with its route recorded; returns
    {photo: (meta without _processing_info, route summary, seconds)}."""
    out = {}
    for rel in photos:
        t0 = time.perf_counter()
        with RouteRecorder(extractor.engine) as rec:
            meta = extractor.extract_metadata_from_images([os.path.join(ROOT, rel)], ocr_image_indices=[0])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        validate_schema(meta)
        meta.pop("_processing_info")
        out[rel] = (meta, rec.summary(), seconds)
        print(f"default route, {label}, {rel}: {seconds:.3f} s; {card}", flush=True)
    return out


def profile_call(fn):
    """(host ms of one synchronised call, device ms and kernel count from
    torch.profiler's CUDA trace of one call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    run = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return host, sum(e.time_range.end - e.time_range.start for e in run) / 1e3, len(run)


def check_default_route(dev, card: str) -> dict:
    """Phase 8: the default route in float32 (held to the JAX package's
    JSON) and bfloat16 (differences printed), the card's beam and labels
    against the CPU's, and the route's timings. Returns the kernels'
    launches over the float32 route."""
    from bbocr_tpu_torch.decode.cc_device import label_components_device
    from bbocr_tpu_torch.preprocess import preprocess_for_book_cover

    with open(DEFAULT_ROUTE) as f:
        ref = json.load(f)["photos"]
    with open(DEFAULT_ROUTE_BF16) as f:
        ref_bf16 = json.load(f)["photos"]
    photos = list(ref)
    engine = default_engine(dev, torch.float32)
    if not (engine.config.host_rectify and engine.config.decoder == "greedy"):
        fail(f"the default engine configuration is not the JAX default: {engine.config}")
    extractor = BookMetadataExtractor(llm_backend="heuristic", engine=engine, device=dev)
    kernels.reset_launches()
    with Recording(engine_module, "ctc_beam_decode_device") as beams, \
            Recording(fastpath_module, "label_components_device", keep_result=True) as labels, \
            Recording(engine_module, "host_warp_crop") as warps:
        got = run_default_route(extractor, photos, "float32", card)
    launches = {name: fn.launches for name, fn in kernels.KERNELS.items()}
    print(f"default route, float32: launches {json.dumps(launches)}", flush=True)
    for name, count in launches.items():
        if count < 1:
            fail(f"kernel {name} was not launched by the default route")
    bad = []
    for rel in photos:
        meta, route, _ = got[rel]
        print(route_line(rel, route, ref[rel]), flush=True)
        if meta != ref[rel]["meta"] or route["route"] != ref[rel]["route"] or route["k"] != ref[rel]["k"]:
            bad.append(rel)
            print(f"    texts {route['texts']}\n    JAX   {ref[rel]['texts']}\n    JSON {json.dumps(meta)}\n"
                  f"    JAX  {json.dumps(ref[rel]['meta'])}", flush=True)
    if bad:
        fail(f"default route, float32: JSON or route differs from the JAX package's on {bad}")
    print(f"default route, float32: the JSON of all {len(photos)} photos equals the JAX package's, routes "
          f"{[got[r][1]['route'] for r in photos]}", flush=True)

    # the card's beam and labels against the CPU's on this run's inputs
    worst = 0.0
    for args, kw in beams.calls:
        logits, lengths = args[0], args[1] if len(args) > 1 else kw.get("lengths")
        on_card = beams.orig(*args, **kw)
        on_cpu = beams.orig(logits.cpu(), None if lengths is None else lengths.cpu(),
                            **{k: v for k, v in kw.items() if k != "lengths"})
        if not (torch.equal(on_card[0].cpu(), on_cpu[0]) and torch.equal(on_card[1].cpu(), on_cpu[1])):
            fail(f"device beam on the card differs from the CPU's on a re-read batch of {tuple(logits.shape)}")
        worst = max(worst, float((on_card[2].cpu() - on_cpu[2]).abs().max()))
    print(f"device beam: {len(beams.calls)} re-read batches {[tuple(a[0].shape) for a, _ in beams.calls]}, "
          f"ids equal to the CPU's, scores within {worst:.3g}", flush=True)
    if not beams.calls or not labels.calls:
        fail(f"the default route made {len(beams.calls)} beam calls and {len(labels.calls)} labelings")
    steps = []
    for (args, kw, (lab, n)) in labels.calls:
        cpu_lab, cpu_n = label_components_device(args[0].cpu(), **kw)
        if not torch.equal(lab.cpu(), cpu_lab) or n != cpu_n:
            fail(f"device labels on the card differ from the CPU's on a mask of {tuple(args[0].shape)}")
        steps.append((tuple(args[0].shape), n))
    print(f"CC labeling: {len(labels.calls)} masks, labels equal to the CPU's; (mask shape, steps) {steps}; "
          f"{card}", flush=True)

    # timings
    big = max(beams.calls, key=lambda c: c[0][0].shape[0] * c[0][0].shape[1])
    host, device, count = profile_call(lambda: beams.orig(*big[0], **big[1]))
    print(f"beam loop on a re-read batch of {tuple(big[0][0].shape)}: {host:.3f} ms host (synchronised), "
          f"{device:.3f} ms device, {count} kernels launched; {card}", flush=True)
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        for args, kw in warps.calls:
            engine_module.host_warp_crop(*args, **kw)
        reps.append((time.perf_counter() - t0) * 1e3 / max(len(warps.calls), 1))
    print(f"host warp: {len(warps.calls)} crops, {statistics.median(reps):.4f} ms per crop (median of 3 passes, "
          f"host CPU of the machine of the {card})", flush=True)

    # bfloat16: an unwrapped engine of the default configuration, as the
    # reference was recorded (the no-engine extractor's is wrapped: phase 9)
    extractor_bf16 = BookMetadataExtractor(llm_backend="heuristic", engine=default_engine(dev), device=dev)
    got_bf16 = run_default_route(extractor_bf16, photos, "bfloat16", card)
    differ = 0
    for rel in photos:
        meta, route, _ = got_bf16[rel]
        print(route_line(rel, route, ref_bf16[rel]), flush=True)
        fields = sorted(k for k in set(meta) | set(ref_bf16[rel]["meta"]) if meta.get(k) != ref_bf16[rel]["meta"].get(k))
        if fields:
            differ += 1
            print(f"    bfloat16 JSON differs from JAX's in {fields}: "
                  f"{json.dumps({k: [meta.get(k), ref_bf16[rel]['meta'].get(k)] for k in fields})}", flush=True)
    print(f"default route, bfloat16: {len(photos) - differ} of {len(photos)} photos' JSON equal to the JAX "
          f"package's bfloat16 JSON (recorded, not required)", flush=True)
    first = photos[0]
    t0 = time.perf_counter()
    run_default_route(extractor_bf16, [first], "bfloat16, warm", card)
    print(f"default route, bfloat16, {first}: first call {got_bf16[first][2]:.3f} s, warm call "
          f"{time.perf_counter() - t0:.3f} s; {card}", flush=True)
    eng = extractor_bf16.engine
    for name in ("book2.png", "book4.png"):
        image = preprocess_for_book_cover(load_rgb(os.path.join(ROOT, "data", "real", "covers", name)), device=dev)[0]
        image = image.cpu().numpy()
        times = {}
        for label, fn in (("readtext_fast", eng.readtext_fast), ("readtext", eng.readtext),
                          ("readtext", eng.readtext), ("readtext_fast", eng.readtext_fast)):
            fn(image)
            t = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn(image)
                torch.cuda.synchronize()
                t.append((time.perf_counter() - t0) * 1e3)
            times.setdefault(label, []).append(statistics.median(t))
        print(f"{name} ({image.shape[0]}x{image.shape[1]}), bfloat16, warm, median of 5 synchronised calls, in turns: "
              f"readtext_fast {times['readtext_fast']} ms, readtext {times['readtext']} ms; {card}", flush=True)
    return launches


class BatchLog:
    """Records, in place, every ``readtext_batch`` call of an engine: the
    images and the results. ``run`` is the unrecorded call."""

    def __init__(self, engine):
        self.engine, self.calls, self.run = engine, [], engine.readtext_batch
        engine.readtext_batch = self.record

    def record(self, images):
        out = self.run(images)
        self.calls.append((list(images), out))
        return out


def route_of_batches(calls):
    """(route, k, chosen results) of one photo from the single-image batches
    a ``BatchingOCR``-wrapped engine received for it."""
    sizes = [len(images) for images, _ in calls]
    if sizes == [1] * 4:
        reads = [out[0] for _, out in calls]
        scores = [(orient.rotation_score(r), orient._wordlike_mass(r)) for r in reads]
        k = max(range(4), key=lambda i: (scores[i], -i))
        return "rotations", k, reads[k]
    if sizes == [1]:
        return "readtext", None, calls[0][1][0]
    fail(f"the wrapped engine received batches of {sizes} for one photo")


def results_equal(a, b) -> bool:
    """Two readings: the same texts, quads and confidences."""
    return len(a) == len(b) and all(
        ta == tb and np.array_equal(np.asarray(qa), np.asarray(qb)) and ca == cb
        for (qa, ta, ca), (qb, tb, cb) in zip(a, b))


def check_shared_route(dev, card):
    """9(a): the no-engine extractor through the shared, wrapped engine.
    Returns (the wrapper, its engine's batch log, each photo's OCR input,
    the kernels' launches)."""
    from bbocr_tpu_torch.extract import extractor as extractor_module
    from bbocr_tpu_torch.runtime.batching import BatchingOCR

    with open(SHARED_ROUTE) as f:
        ref = json.load(f)["photos"]
    if os.environ.get("BB_OCR_BATCHING") is not None:
        fail("BB_OCR_BATCHING is set: phase 9 checks the default wrapping")
    extractor_module._ENGINE_CACHE.clear()
    logs = []
    from_checkpoint = OCREngine.__dict__["from_checkpoint"]

    def float32_engine(cls, craft, crnn, config=None, **kw):
        # the shared engine's default configuration, in the reference's float32
        engine = from_checkpoint.__func__(cls, craft, crnn, EngineConfig(compute_dtype=torch.float32), **kw)
        logs.append(BatchLog(engine))
        return engine

    OCREngine.from_checkpoint = classmethod(float32_engine)
    try:
        extractor = BookMetadataExtractor(llm_backend="heuristic", device=dev)
        wrapper = extractor.engine
    finally:
        OCREngine.from_checkpoint = from_checkpoint
    if not isinstance(wrapper, BatchingOCR) or len(logs) != 1:
        fail(f"the no-engine extractor's engine is a {type(wrapper).__name__}, not one BatchingOCR")
    log = logs[0]
    inputs, bad = {}, []
    kernels.reset_launches()
    for rel in ref:
        log.calls.clear()
        t0 = time.perf_counter()
        meta = extractor.extract_metadata_from_images([os.path.join(ROOT, rel)], ocr_image_indices=[0])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        validate_schema(meta)
        meta.pop("_processing_info")
        route, k, chosen = route_of_batches(log.calls)
        inputs[rel] = log.calls[0][0][0]  # the unrotated OCR input
        got = {"route": route, "k": k, "boxes": len(chosen)}
        want = {key: ref[rel][key] for key in got}
        print(f"  {rel}: {seconds:.3f} s; {json.dumps(got)}; JAX {json.dumps(want)}", flush=True)
        if meta != ref[rel]["meta"] or got != want:
            bad.append(rel)
            print(f"    texts {[t for _, t, _ in chosen]}\n    JAX   {ref[rel]['texts']}\n    JSON {json.dumps(meta)}\n"
                  f"    JAX  {json.dumps(ref[rel]['meta'])}", flush=True)
    launches = {name: fn.launches for name, fn in kernels.KERNELS.items()}
    print(f"no-engine extractor: launches {json.dumps(launches)}; {wrapper.batches_dispatched} batches, "
          f"{wrapper.images_processed} images; {card}", flush=True)
    if bad:
        fail(f"no-engine extractor, float32: JSON, route or k differs from the JAX package's on {bad}")
    for name, count in launches.items():
        if count < 1:
            fail(f"kernel {name} was not launched by the no-engine extractor's route")
    print(f"no-engine extractor (BatchingOCR-wrapped shared engine), float32: the JSON, route and k of all "
          f"{len(ref)} photos equal the JAX package's", flush=True)
    return wrapper, log, inputs, launches


def check_batcher(wrapper, log, inputs, card) -> None:
    """9(b): 6 threads each submit the six OCR inputs; every result must
    equal one ``readtext_batch`` call on the batch it was coalesced into."""
    photos = list(inputs.values())
    log.calls.clear()
    batches0, images0 = wrapper.batches_dispatched, wrapper.images_processed
    errors = []

    def client(t):
        try:
            for img in photos:
                wrapper.readtext(img, timeout=600)
        except Exception as e:  # reported below, and the run fails
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(t,)) for t in range(6)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    seconds = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f"BatchingOCR under load: {errors or 'a client did not finish'}")
    requests = 6 * len(photos)
    batches = wrapper.batches_dispatched - batches0
    images = wrapper.images_processed - images0
    print(f"BatchingOCR under 6 threads: {requests} requests in {batches} batches (batches_dispatched), "
          f"{images} images_processed, sizes {[len(i) for i, _ in log.calls]}, {batches / requests:.4f} batches "
          f"per request; {seconds:.3f} s; {card}", flush=True)
    if images != requests or batches >= requests:
        fail(f"BatchingOCR under load: {batches} batches for {requests} requests, {images} images processed")
    for images_in, out in log.calls:
        again = log.run(images_in)
        if not all(results_equal(a, b) for a, b in zip(again, out)):
            fail(f"a coalesced batch of {len(images_in)} differs from readtext_batch on the same images")
    print(f"BatchingOCR: all {len(log.calls)} coalesced batches equal readtext_batch on the same compositions",
          flush=True)


def stream_photos():
    """The covers and the repository's JPEGs, in ``bench.py``'s order."""
    import glob

    paths = sorted(glob.glob(os.path.join(ROOT, "data", "real", "covers", "*.png")))
    paths += sorted(glob.glob(os.path.join(ROOT, "data", "real", "photos", "*", "*.jpg")))
    paths += sorted(glob.glob(os.path.join(ROOT, "books", "*", "*.jpg")))
    return [load_rgb(p) for p in paths]


def time_host_resize(card) -> None:
    """The numpy letterbox resize of eight camera-sized images (2400x1800
    to 1408x1056) in a loop and mapped over the engine's host pool, twice
    each: a ratio well above 1 means the resize runs without the GIL for
    most of its time."""
    images = [np.random.default_rng(i).integers(0, 256, (2400, 1800), dtype=np.uint8) for i in range(8)]
    resize = lambda g: engine_module._host_resize(g, 1408, 1056)  # noqa: E731
    pool = engine_module._letterbox_pool()
    list(pool.map(resize, images))  # start the threads, touch the pages
    for _ in range(2):
        t0 = time.perf_counter()
        for g in images:
            resize(g)
        serial = time.perf_counter() - t0
        t0 = time.perf_counter()
        list(pool.map(resize, images))
        pooled = time.perf_counter() - t0
        print(f"host resize of 8 images, 2400x1800 -> 1408x1056: loop {serial:.4f} s, host pool {pooled:.4f} s, "
              f"ratio {serial / pooled:.3f} ({os.cpu_count()} CPUs of the host of the {card})", flush=True)


def check_stream(dev, card) -> None:
    """9(c): ``readtext_stream`` in batches of 8 on the default (bfloat16)
    engine; each batch equal to ``readtext_batch``, whose first pass (with
    the host pool) also warms every shape, as ``bench.py`` does. The stream
    runs with the host stages in serial loops (the engine before the host
    pool was ported) and on the host pool, in the order A B B A, as the
    passes grow faster over a run; then a warm ``readtext_batch`` pass over
    the same batches, timed for comparison."""
    time_host_resize(card)
    engine = default_engine(dev)
    photos = stream_photos()
    batches = [photos[i:i + 8] for i in range(0, len(photos), 8)]
    t0 = time.perf_counter()
    want = [engine.readtext_batch(b) for b in batches]
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    pooled = engine_module._host_map
    variants = {"serial host stages": engine_module._serial_map, "host pool": pooled}
    rates = {label: [] for label in variants}
    order = list(variants) + list(variants)[::-1]
    for label in order:
        engine_module._host_map = variants[label]
        try:
            engine.timers.reset()
            t0 = time.perf_counter()
            got = list(engine.readtext_stream(iter(batches)))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            engine_module._host_map = pooled
        stages = engine.timings()
        for i, (g, w) in enumerate(zip(got, want)):
            if len(g) != len(w) or not all(results_equal(a, b) for a, b in zip(g, w)):
                fail(f"readtext_stream ({label}) batch {i} differs from readtext_batch")
        if len(got) != len(batches):
            fail(f"readtext_stream yielded {len(got)} batches for {len(batches)}")
        boxes = sum(len(r) for b in got for r in b)
        rates[label].append(len(photos) / seconds)
        print(f"readtext_stream, bfloat16, {label}: {len(photos)} photos in {len(batches)} batches of 8, every "
              f"batch equal to readtext_batch; {seconds:.3f} s, {len(photos) / seconds:.3f} photos per second, "
              f"{boxes} boxes; {card}", flush=True)
        print(f"readtext_stream stage times, {label} (host wall, summed over the stage threads): "
              f"{json.dumps(stages)}; {card}", flush=True)
    print(f"readtext_stream, photos per second in the order A B B A: "
          f"{json.dumps({k: [round(r, 3) for r in v] for k, v in rates.items()})}; {card}", flush=True)
    t0 = time.perf_counter()
    for b in batches:
        engine.readtext_batch(b)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    print(f"readtext_batch over the same batches (host pool), first pass {first:.3f} s, warm pass after the "
          f"streams {warm:.3f} s ({len(photos) / warm:.3f} photos per second); {card}", flush=True)


def warmup_probe(mode: str) -> int:
    """``--warmup-probe with|without``, in a fresh process: book2.png's first
    ``readtext`` on the default (bfloat16) engine after ``warmup()`` or
    without it, and its second call; one JSON line."""
    dev = torch.device("cuda", 0)
    image = _preprocess(load_rgb(os.path.join(ROOT, "data", "real", "covers", "book2.png")), 1.5, "cpu", PLAIN_OPS)
    image = image.numpy()  # preprocessed on the CPU: nothing has run on the card yet
    t0 = time.perf_counter()
    engine = default_engine(dev)
    torch.cuda.synchronize()
    out = {"mode": mode, "load_s": time.perf_counter() - t0}
    if mode == "with":
        t0 = time.perf_counter()
        out["warmup_calls"] = engine.warmup()
        torch.cuda.synchronize()
        out["warmup_s"] = time.perf_counter() - t0
    for key in ("first_call_s", "second_call_s"):
        t0 = time.perf_counter()
        engine.readtext(image)
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


def check_warmup(card) -> None:
    """9(d): the two probes, one fresh process each."""
    rows = {}
    for mode in ("without", "with"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--warmup-probe", mode], cwd=ROOT,
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            fail(f"warm-up probe '{mode}' failed:\n{proc.stderr[-2000:]}")
        rows[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
    w, wo = rows["with"], rows["without"]
    print(f"warmup, bfloat16, fresh process each: {w['warmup_calls']} calls in {w['warmup_s']:.3f} s; book2.png "
          f"first call {wo['first_call_s']:.3f} s without warmup (second {wo['second_call_s']:.3f} s), "
          f"{w['first_call_s']:.3f} s after it (second {w['second_call_s']:.3f} s); engine load "
          f"{wo['load_s']:.3f} / {w['load_s']:.3f} s; {card}", flush=True)
    if w["warmup_calls"] != 1 + len(EngineConfig().canvases):
        fail(f"warmup made {w['warmup_calls']} calls")


def check_autocrop(dev, card) -> dict:
    """9(e): the rectangles of the six preprocessed photos, the
    ``crop_for_ocr=True`` extractor's JSON and routes, the kernels' launches
    over that route, and ``text_mask``'s time at a cover's size."""
    from bbocr_tpu_torch.preprocess import auto_crop_text_region, preprocess_for_book_cover, text_mask

    with open(AUTOCROP) as f:
        ref = json.load(f)["photos"]
    bad = []
    for rel, entry in ref.items():
        pre = preprocess_for_book_cover(load_rgb(os.path.join(ROOT, rel)), device=dev)[0]
        rect = auto_crop_text_region(pre, 128)
        got = None if rect is None else list(rect)
        print(f"  {rel}: preprocessed {list(pre.shape)}, crop {got}; JAX {entry['preprocessed_shape']}, "
              f"{entry['rect']}", flush=True)
        if got != entry["rect"] or list(pre.shape) != entry["preprocessed_shape"]:
            bad.append(rel)
        if rel.endswith("book1.png"):
            masked = lambda pre=pre: text_mask(pre)  # noqa: E731
            device = profiled_device_ms(masked, "", reps=5)
            print(f"text_mask at {tuple(pre.shape)}: {median_ms(masked, reps=5):.4f} ms per call (CUDA events), "
                  f"{'not measured' if device is None else f'{device:.4f} ms'} device time; {card}", flush=True)
    if bad:
        fail(f"auto-crop rectangles differ from the JAX package's on {bad}")
    extractor = BookMetadataExtractor(llm_backend="heuristic", crop_for_ocr=True,
                                      engine=default_engine(dev, torch.float32), device=dev)
    kernels.reset_launches()
    got = run_default_route(extractor, list(ref), "auto-crop, float32", card)
    launches = {name: fn.launches for name, fn in kernels.KERNELS.items()}
    for rel in ref:
        meta, route, _ = got[rel]
        print(route_line(rel, route, ref[rel]), flush=True)
        if meta != ref[rel]["meta"] or route["route"] != ref[rel]["route"] or route["k"] != ref[rel]["k"]:
            bad.append(rel)
            print(f"    JSON {json.dumps(meta)}\n    JAX  {json.dumps(ref[rel]['meta'])}", flush=True)
    print(f"auto-crop route: launches {json.dumps(launches)}", flush=True)
    if bad:
        fail(f"crop_for_ocr=True, float32: JSON or route differs from the JAX package's on {bad}")
    for name, count in launches.items():
        if count < 1:
            fail(f"kernel {name} was not launched by the auto-crop route")
    print(f"auto-crop: the rectangles, JSON and routes of all {len(ref)} photos equal the JAX package's", flush=True)
    return launches


def check_engine_options(dev, card) -> None:
    """9(f): book1.png under each engine option against the JAX package's
    readings; the letterbox and detect stages' ms per read (mean of 3 warm
    reads)."""
    with open(ENGINE_OPTIONS) as f:
        ref = json.load(f)
    image = _preprocess(load_rgb(BOOK1), 1.5, dev, KERNEL_OPS).cpu().numpy()
    if list(image.shape) != ref["image_shape"]:
        fail(f"book1.png preprocessed to {image.shape}, the reference to {ref['image_shape']}")
    bad = []
    for name, entry in ref["options"].items():
        engine = default_engine(dev, torch.float32, **entry["config"])
        res = engine.readtext(image)
        want = entry["readtext"]
        texts = [t for _, t, _ in res]
        err = max((float(np.abs(np.asarray(q) - np.asarray(rq)).max()) for (q, _, _), rq in zip(res, want["quads"])),
                  default=0.0)
        engine.timers.reset()
        for _ in range(3):
            engine.readtext(image)
        torch.cuda.synchronize()
        stages = engine.timings()
        print(f"  {name}: {len(res)} boxes (JAX {len(want['texts'])}), texts "
              f"{'equal' if texts == want['texts'] else 'DIFFER'}, quads within {err:.4f} px; letterbox "
              f"{stages['letterbox']['total_s'] * 1e3 / 3:.2f} ms, detect {stages['detect']['total_s'] * 1e3 / 3:.2f} "
              f"ms per read; {card}", flush=True)
        if texts != want["texts"] or err > 1.0:
            bad.append(name)
            print(f"    texts {texts}\n    JAX   {want['texts']}", flush=True)
    if bad:
        fail(f"engine options: book1.png's reading differs from the JAX package's under {bad}")


def float32_config(**config) -> EngineConfig:
    return EngineConfig(compute_dtype=torch.float32, **config)


# One float32 reading of the port differs from the JAX package's, on the CPU
# as on the card: in photos/5's IMG_9692.jpg turned by k = 3, one region-map
# pixel lies within 2e-6 of the 0.4 threshold (0.3999981 in the port,
# 0.40000123 in JAX: the convs' float32 sums run in another order; the maps
# agree within 1.5e-5; ``WITNESS``, and ``check_threshold_witness`` on the
# card), so one component differs by that pixel, its quad by 0.9 px, and
# the crop reads "AS" (0.707) where JAX reads "A" (0.992).
# (book, index in ``results``) -> (JAX text, the port's text); the check
# requires exactly this pair there and equality everywhere else.
KNOWN_READINGS = {("photos/5", 47): ("A", "AS")}


def evaluate_real_problems(got: dict, ref: dict) -> list:
    """Where an ``evaluate_real`` summary differs from the JAX package's:
    per book the rotations and the texts of ``results`` (confidences within
    1e-3; ``KNOWN_READINGS`` excepted), then the corpus recall, CER and
    per-field accuracy."""
    bad = []
    rows = {r["book"]: r for r in got["details"]}
    for want in ref["details"]:
        row = rows.get(want["book"])
        if row is None:
            bad.append(f"{want['book']}: missing")
            continue
        results, ref_results = list(row["results"]), list(want["results"])
        for (book, i), (jax_text, port_text) in KNOWN_READINGS.items():
            if book == want["book"] and i < min(len(results), len(ref_results)):
                if results[i][0] != port_text or ref_results[i][0] != jax_text:
                    bad.append(f"{book}: result {i} reads {results[i][0]!r} (JAX {ref_results[i][0]!r}), "
                               f"not the known {port_text!r} (JAX {jax_text!r})")
                results[i] = ref_results[i]
        texts, ref_texts = [t for t, _ in results], [t for t, _ in ref_results]
        conf_err = max((abs(c - rc) for (_, c), (_, rc) in zip(results, ref_results)), default=0.0)
        if row["rotations"] != want["rotations"] or texts != ref_texts or conf_err > 1e-3 + 1e-9:
            bad.append(f"{want['book']}: rotations {row['rotations']} (JAX {want['rotations']}), texts "
                       f"{'equal' if texts == ref_texts else texts}, confidences within {conf_err:.4f}")
    for key in ("tpu_mean_word_recall", "tpu_mean_phrase_cer", "per_field"):
        if got[key] != ref[key]:
            bad.append(f"{key}: {got[key]} (JAX {ref[key]})")
    return bad


def corpus_line(summary: dict) -> str:
    fields = {f: v["fuzzy_acc"] for f, v in summary["per_field"].items()}
    return (f"word recall {summary['tpu_mean_word_recall']}, phrase CER {summary['tpu_mean_phrase_cer']}, "
            f"covers {summary.get('tpu_mean_word_recall_on_paired')} / {summary.get('tpu_mean_phrase_cer_on_paired')}, "
            f"fuzzy field accuracy {json.dumps(fields)}")


def check_threshold_witness(dev, card) -> None:
    """The cause of ``KNOWN_READINGS`` on the card: the float32 region map
    of the witness canvas against both packages' CPU maps around the pixels
    where their masks differ. The card's patch must lie within 1e-4 of
    JAX's (the CPU maps differ by ``max_abs_diff_region``), and each such
    pixel on the port's side of the threshold, where the known reading
    comes from."""
    from bbocr_tpu_torch.io import load_gray
    from bbocr_tpu_torch.runtime import bucketing

    with open(WITNESS) as f:
        w = json.load(f)
    gray = engine_module._to_gray_u8(np.rot90(load_gray(os.path.join(REAL_DIR, w["book"], w["image"])), w["k"]))
    h, wd = w["canvas"]
    _, oh, ow = bucketing.letterbox_params(gray.shape[0], gray.shape[1], bucketing.CanvasSpec(h, wd))
    batch = np.zeros((1, h, wd), np.float32)
    batch[0, :oh, :ow] = engine_module._host_resize(gray, oh, ow)
    engine = default_engine(dev, torch.float32)
    with torch.no_grad():
        region = engine.craft(engine.craft_input(torch.from_numpy(batch).to(dev)))[0, 0].cpu().numpy()
    y0, x0 = w["patch_origin"]
    jax_patch, cpu_patch = np.asarray(w["jax_region_patch"]), np.asarray(w["port_region_patch"])
    patch = region[y0:y0 + jax_patch.shape[0], x0:x0 + jax_patch.shape[1]]
    err_jax, err_cpu = float(np.abs(patch - jax_patch).max()), float(np.abs(patch - cpu_patch).max())
    print(f"  threshold witness ({w['book']}/{w['image']}, k = {w['k']}, canvas {h}x{wd}): the card's region map "
          f"within {err_jax:.3g} of JAX's and {err_cpu:.3g} of the port's CPU map on a {patch.shape} patch (CPU maps "
          f"apart by {w['max_abs_diff_region']:.3g}); {card}", flush=True)
    for p in w["pixels"]:
        got = float(region[p["y"], p["x"]])
        print(f"    map pixel ({p['y']}, {p['x']}): card {got!r}, port CPU {p['port_region']!r}, JAX "
              f"{p['jax_region']!r}, threshold {w['low_text']}", flush=True)
        if (got > w["low_text"]) != (p["port_region"] > w["low_text"]):
            fail(f"threshold witness: the card's region at {p['y']}, {p['x']} is {got}, on the other side of "
                 f"{w['low_text']} from the port's CPU map")
    if err_jax > 1e-4:
        fail(f"threshold witness: the card's region map differs from JAX's by {err_jax} (limit 1e-4)")


def check_evaluate_real(dev, card) -> None:
    """10(a): ``evaluate_real`` over the 21 books of ``data/real/``: in
    float32 held to the JAX package's run, then in bfloat16 (the default
    engine) printed beside the JAX package's bfloat16 run."""
    from bbocr_tpu_torch.cli.evaluate_real import evaluate_real

    paths = dict(craft=os.path.join(CKPT, "craft.npz"), crnn=os.path.join(CKPT, "crnn.npz"), device=dev)
    with open(EVAL_REAL) as f:
        ref = json.load(f)
    with float32_engines():
        t0 = time.perf_counter()
        got = evaluate_real(REAL_DIR, **paths)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    bad = evaluate_real_problems(got, ref)
    print(f"evaluate_real, float32: {got['books']} books in {seconds:.3f} s; {corpus_line(got)}; {card}", flush=True)
    for (book, i), (jax_text, port_text) in KNOWN_READINGS.items():
        print(f"  known difference (a region-map pixel at the threshold): {book} result {i} reads {port_text!r}, "
              f"JAX {jax_text!r}", flush=True)
    print(f"  JAX float32 (CPU): {corpus_line(ref)}", flush=True)
    check_threshold_witness(dev, card)
    for line in bad:
        print(f"  DIFFERS {line}", flush=True)
    if bad:
        fail(f"evaluate_real, float32: {len(bad)} differences from the JAX package's run")
    with open(EVAL_REAL_BF16) as f:
        ref16 = json.load(f)
    t0 = time.perf_counter()
    got16 = evaluate_real(REAL_DIR, **paths)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    pairs = list(zip(got16["details"], ref16["details"]))
    turned = sum(a["rotations"] == b["rotations"] for a, b in pairs)
    same = sum(a["rotations"] == b["rotations"] and [t for t, _ in a["results"]] == [t for t, _ in b["results"]]
               for a, b in pairs)
    print(f"evaluate_real, bfloat16: {got16['books']} books in {seconds:.3f} s; {corpus_line(got16)}; {card}",
          flush=True)
    print(f"  JAX bfloat16 (CPU): {corpus_line(ref16)}; books with JAX's rotations {turned} of {len(pairs)}, "
          f"read alike (rotations and texts) {same} of {len(pairs)}", flush=True)


@contextlib.contextmanager
def float32_engines():
    """Within the block, ``OCREngine.from_checkpoint`` builds its engines in
    float32 and otherwise the default configuration (for ``evaluate_real``'s
    engine and the no-engine extractor's shared one), and the shared-engine
    cache starts empty; the shared engines are closed at its end."""
    from_checkpoint = OCREngine.__dict__["from_checkpoint"]
    OCREngine.from_checkpoint = classmethod(lambda cls, craft, crnn, *_, device="cuda", **__: from_checkpoint.__func__(
        cls, craft, crnn, float32_config(), device=device))
    close_shared_engines()
    try:
        yield
    finally:
        OCREngine.from_checkpoint = from_checkpoint
        close_shared_engines()


def close_shared_engines() -> None:
    from bbocr_tpu_torch.extract import extractor as extractor_module

    for engine in extractor_module._ENGINE_CACHE.values():
        engine.close()
    extractor_module._ENGINE_CACHE.clear()


def check_evaluate_books(dev, card) -> dict:
    """10(b): ``evaluate_books`` over ``books/`` through the no-engine
    extractor (preprocessing kernels, the shared engine in ``BatchingOCR``,
    rotations): in float32 each book's fields equal the JAX package's, with
    every kernel launch count set to 0 just before and read just after;
    then in bfloat16 the per-field accuracy beside JAX's."""
    from bbocr_tpu_torch.cli.evaluate import evaluate_books

    if os.environ.get("BB_OCR_BATCHING") is not None:
        fail("BB_OCR_BATCHING is set: phase 10 evaluates the default wrapping")
    with open(EVAL_BOOKS) as f:
        ref = json.load(f)
    with float32_engines():
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = evaluate_books(BOOKS_DIR, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.KERNELS.items()}
    rows = {r["book"]: r for r in got["details"]}
    bad = [want["book"] for want in ref["details"]
           if rows.get(want["book"], {}).get("fields") != want["fields"] or rows[want["book"]]["error"]]
    print(f"evaluate_books, float32: {got['books']} books in {seconds:.3f} s; per field "
          f"{json.dumps(got['per_field'])}, mean CER {got['mean_cer']}; launches {json.dumps(launches)}; {card}",
          flush=True)
    for book in bad:
        print(f"  DIFFERS book {book}: {json.dumps(rows.get(book))}\n  JAX {json.dumps(next(r for r in ref['details'] if r['book'] == book))}", flush=True)
    if bad or got["per_field"] != ref["per_field"]:
        fail(f"evaluate_books, float32: fields differ from the JAX package's on books {bad}")
    for name, count in launches.items():
        if count < 1:
            fail(f"kernel {name} was not launched by evaluate_books")
    with open(EVAL_BOOKS_BF16) as f:
        ref16 = json.load(f)
    t0 = time.perf_counter()
    got16 = evaluate_books(BOOKS_DIR, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    close_shared_engines()
    raised = [r["book"] for r in got16["details"] if r["error"]]
    if raised:
        fail(f"evaluate_books, bfloat16: books {raised} raised")
    acc = lambda summary: {f: v["fuzzy_acc"] for f, v in summary["per_field"].items()}  # noqa: E731
    print(f"evaluate_books, bfloat16: {got16['books']} books in {seconds:.3f} s; fuzzy accuracy "
          f"{json.dumps(acc(got16))}, mean CER {got16['mean_cer']}; JAX bfloat16 (CPU) {json.dumps(acc(ref16))}, "
          f"mean CER {ref16['mean_cer']}; {card}", flush=True)
    return launches


def check_layouts(dev, card, size=(1408, 1024)) -> None:
    """10(c): engines of the lite and published detector layouts, from
    seeded variables of the flax shapes in ``tests/data/layouts_jax_shapes.json``:
    the card's float32 score maps at the full canvas (``size``) against the same
    engine's on the CPU, then one ``readtext`` each with the detect stage's
    time beside the default CRAFT's."""
    from bbocr_tpu_torch.utils.checkpoint import load_params

    with open(LAYOUTS) as f:
        shapes = json.load(f)
    crnn = load_params(os.path.join(CKPT, "crnn.npz"))
    gray = np.random.default_rng(0).uniform(0, 255, size).astype(np.float32)
    engines = {"CRAFT (craft.npz)": default_engine(dev, torch.float32)}
    for name in ("lite", "published"):
        variables = seeded_variables(shapes[name], shapes["seed"])
        engine = OCREngine(variables, crnn, float32_config(), device=dev)
        cpu = OCREngine(variables, crnn, float32_config(), device="cpu")
        with torch.no_grad():
            x = torch.from_numpy(gray)[None]
            want = cpu.craft(cpu.craft_input(x)).numpy()
            got = engine.craft(engine.craft_input(x.to(dev))).cpu().numpy()
        # float32 with TF32 off: cuDNN and the CPU sum in other orders
        limit = 1e-3 * max(1.0, float(np.abs(want).max()))
        err = float(np.abs(got - want).max())
        print(f"{type(engine.craft).__name__} ({name} layout, seed {shapes['seed']}), float32 maps at "
              f"{size[0]}x{size[1]}: card against CPU within {err:.3g} (limit {limit:.3g}, largest "
              f"magnitude {float(np.abs(want).max()):.4g}); {card}", flush=True)
        if err > limit:
            fail(f"{name} layout: the card's score maps differ from the CPU's by {err} (limit {limit})")
        engines[f"{type(engine.craft).__name__} ({name})"] = engine
    for label, engine in engines.items():
        engine.readtext(gray)  # first call: cuDNN's choices for the shapes
        torch.cuda.synchronize()
        engine.timers.reset()
        res = engine.readtext(gray)
        torch.cuda.synchronize()
        stages = engine.timings()
        print(f"  {label}: readtext of a {size[0]}x{size[1]} noise image, {len(res)} boxes; detect "
              f"{stages['detect']['total_s'] * 1e3:.2f} ms, all stages "
              f"{json.dumps({k: round(v['total_s'] * 1e3, 2) for k, v in stages.items()})} ms; {card}", flush=True)


def sha256(data) -> str:
    return hashlib.sha256(data.tobytes() if isinstance(data, np.ndarray) else data).hexdigest()


def encode_input(rel: str) -> np.ndarray:
    """An input of ``tests/data/encode_jax_sha256.json``: a repository photo
    as the port loads it, or book1 as the port's chain preprocessed it on
    the CPU (gray, float32)."""
    from bbocr_tpu_torch.io import read_png

    if rel.startswith("tests/data/"):
        return read_png(os.path.join(ROOT, rel)).astype(np.float32)
    return load_rgb(os.path.join(ROOT, rel))


def check_encoders(dev, card) -> None:
    """11(a): the model inputs' JPEGs and the trace's PNG previews, without
    Pillow, against the SHA-256 of what the JAX extractor's Pillow calls
    make of the same inputs; ms per encode."""
    import base64

    from bbocr_tpu_torch.io import decode_png

    with open(ENCODE_REFERENCE) as f:
        ref = json.load(f)
    settings = [tuple(v) for v in ref["settings"]]
    encode, preview = BookMetadataExtractor._encode_jpeg_b64, BookMetadataExtractor._to_data_url
    times = {f"jpeg {d} px q{q}": [] for d, q in settings}
    times["png preview 800 px"] = []
    for rel, want in ref["inputs"].items():
        arr = encode_input(rel)
        if list(arr.shape) != want["shape"] or sha256(np.ascontiguousarray(arr)) != want["sha256"]:
            fail(f"{rel}: the input differs from the one the reference encoded")
        for (d, q), digest in zip(settings, want["jpeg_sha256"]):
            t0 = time.perf_counter()
            blob = base64.b64decode(encode(arr, d, q))
            times[f"jpeg {d} px q{q}"].append((time.perf_counter() - t0) * 1e3)
            if sha256(blob) != digest:
                fail(f"{rel}: the JPEG at {d} px, quality {q} differs from Pillow's (JAX extractor)")
        t0 = time.perf_counter()
        url = preview(arr)
        times["png preview 800 px"].append((time.perf_counter() - t0) * 1e3)
        pixels = decode_png(base64.b64decode(url.split(",", 1)[1]))
        if list(pixels.shape) != want["preview_shape"] or sha256(np.ascontiguousarray(pixels)) != want["preview_sha256"]:
            fail(f"{rel}: the PNG preview's pixels differ from the JAX extractor's")
    from bbocr_tpu_torch.preprocess import preprocess_for_book_cover

    on_card = preprocess_for_book_cover(load_rgb(BOOK1), device=dev)[0].cpu().numpy()
    cpu = encode_input("tests/data/book1_preprocessed_port_f32.png")
    digests = [sha256(base64.b64decode(encode(on_card, d, q))) for d, q in settings]
    want = ref["inputs"]["tests/data/book1_preprocessed_port_f32.png"]["jpeg_sha256"]
    print(f"book1 preprocessed on the card: {int((on_card != cpu).sum())} pixels differ from the CPU chain's "
          f"(the bicubic resize's sums); its JPEGs {'equal' if digests == want else 'differ from'} "
          f"JAX's of the CPU array (not required)", flush=True)
    shown = {k: f"median {statistics.median(v):.3f} ms, max {max(v):.3f} ms" for k, v in times.items()}
    print(f"encoders: {len(ref['inputs'])} inputs, every JPEG byte-equal and every preview pixel-equal to the "
          f"JAX extractor's; per encode (host, thumbnail included) {json.dumps(shown)}; {card}", flush=True)


@contextlib.contextmanager
def watch_llm_calls():
    """Within the block every LLM call must answer: an exception in a
    client's ``generate`` (which Ollama's retries would swallow) or in the
    extractor's ``_call_llm`` is recorded and fails the run at the next
    phase."""
    from bbocr_tpu_torch.llm import client

    targets = [(BookMetadataExtractor, "_call_llm")] + [
        (getattr(client, n), "generate") for n in ("OllamaClient", "OpenAIClient", "GeminiClient")]
    saved = [(cls, name, cls.__dict__[name]) for cls, name in targets]
    for cls, name, fn in saved:
        setattr(cls, name, _recorded(f"{cls.__name__}.{name}", fn))
    try:
        yield
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


@contextlib.contextmanager
def llm_env(env: dict):
    keys = list(env) + ["OPENAI_BASE_URL", "GOOGLE_API_KEY", "GOOGLE_API_BASE"]
    saved = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def llm_runs(ref: dict, dev, backends) -> tuple:
    """The no-engine extractor on the reference's books for each backend,
    through the reference's canned session, with ``capture_trace=True``:
    ({backend: {book: record}}, seconds per book, host ms of the encoders)."""
    from scripts.torch_port_reference import CannedSession, book_images, route_record

    runs, seconds, encode_ms = {}, [], []
    encode = BookMetadataExtractor.__dict__["_encode_jpeg_b64"]

    def timed_encode(*args):
        t0 = time.perf_counter()
        out = encode.__func__(*args)
        encode_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    BookMetadataExtractor._encode_jpeg_b64 = staticmethod(timed_encode)
    try:
        for backend in backends:
            ext = BookMetadataExtractor(llm_backend=backend, model=ref["models"][backend], warm_model=False, device=dev)
            runs[backend] = {}
            for book in ref["books"]:
                ext.session = CannedSession(ref["replies"], ref["models"]["gemini"])
                t0 = time.perf_counter()
                meta = ext.extract_metadata_from_images(book_images(book), capture_trace=True)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                runs[backend][book] = route_record(meta, ext.session)
    finally:
        BookMetadataExtractor._encode_jpeg_b64 = encode
    return runs, seconds, encode_ms


def route_differences(got: dict, want: dict) -> tuple:
    """(required parts that differ, the OCR'd photos' JPEG digests that
    differ) of one book's run against the reference's."""
    bad = [k for k in ("meta", "steps") if got[k] != want[k]]
    if len(got["posts"]) != len(want["posts"]):
        return bad + ["posts"], []
    for i, (g, w) in enumerate(zip(got["posts"], want["posts"])):
        bad += [f"post {i} {k}" for k in ("url", "headers", "timeout", "body", "prompt") if g[k] != w[k]]
        if g["image_sha256"][:1] != w["image_sha256"][:1]:
            bad.append(f"post {i} cover JPEG")
    g, w = got["posts"][-1]["image_sha256"], want["posts"][-1]["image_sha256"]
    return bad, [(j, a, b) for j, (a, b) in enumerate(zip(g, w)) if j and a != b]


def check_llm_route(dev, card) -> dict:
    """11(b): the LLM route of the no-engine extractor (preprocessing
    kernels, the shared engine in ``BatchingOCR``, rotations, the JPEG
    encoder, the trace) for ``ollama``, ``openai`` and ``gemini`` on
    ``books/1`` to ``books/3``, float32: each prompt, the cover's JPEG, the
    metadata and the trace's steps equal the JAX package's CPU run, every
    kernel launch count set to 0 just before and read just after; the OCR'd
    photos' JPEG digests printed; then bfloat16's differences printed."""
    if os.environ.get("BB_OCR_BATCHING") is not None:
        fail("BB_OCR_BATCHING is set: phase 11 runs the default wrapping")
    with open(LLM_ROUTE) as f:
        ref = json.load(f)
    backends = list(ref["runs"])
    with llm_env(ref["env"]), watch_llm_calls():
        with float32_engines():
            kernels.reset_launches()
            runs, seconds, encode_ms = llm_runs(ref, dev, backends)
            launches = {name: fn.launches for name, fn in kernels.KERNELS.items()}
        failed = []
        for backend in backends:
            for book in ref["books"]:
                bad, jpegs = route_differences(runs[backend][book], ref["runs"][backend][book])
                meta = runs[backend][book]["meta"]
                print(f"  {backend} book {book}: {'equal' if not bad else 'DIFFERS in ' + ', '.join(bad)}; "
                      f"{json.dumps({k: v for k, v in meta.items() if not k.startswith('_')})}", flush=True)
                for j, got_sha, want_sha in jpegs:
                    print(f"    photo {j}'s JPEG (OCR'd, preprocessed on the card) {got_sha} against "
                          f"JAX's {want_sha}: differs (not required)", flush=True)
                if bad:
                    failed.append((backend, book, bad))
                    print(f"    got  {json.dumps(runs[backend][book])[:3000]}\n    JAX  "
                          f"{json.dumps(ref['runs'][backend][book])[:3000]}", flush=True)
        print(f"LLM route, float32: {len(seconds)} book runs, {statistics.median(seconds):.3f} s per book "
              f"(median; max {max(seconds):.3f}), JPEG encodes {len(encode_ms)} at median "
              f"{statistics.median(encode_ms):.3f} ms (max {max(encode_ms):.3f}); launches {json.dumps(launches)}; "
              f"{card}", flush=True)
        if failed:
            fail(f"the LLM route differs from the JAX package's: {failed}")
        for name, count in launches.items():
            if count < 1:
                fail(f"kernel {name} was not launched by the LLM route")
        close_shared_engines()
        runs16, seconds16, _ = llm_runs(ref, dev, backends[:1])
        close_shared_engines()
    for book in ref["books"]:
        bad, jpegs = route_differences(runs16[backends[0]][book], ref["runs"][backends[0]][book])
        print(f"  bfloat16 {backends[0]} book {book}: against the JAX float32 run "
              f"{'equal' if not bad else 'differs in ' + ', '.join(bad)}; {len(jpegs)} OCR'd JPEGs differ", flush=True)
    print(f"LLM route, bfloat16: {statistics.median(seconds16):.3f} s per book (median); {card}", flush=True)
    return launches


def check_host_clis(card) -> None:
    """11(c): ``process_book`` on the default Ollama backend through a
    canned session, ``batch`` on the heuristic backend over three books
    with 1 and 2 workers, ``smoke --books-dir books``, ``profile_engine``."""
    import io
    import shutil
    import tempfile

    from bbocr_tpu_torch.cli import batch, process_book, profile_engine, smoke
    from bbocr_tpu_torch.extract import extractor as extractor_module
    from scripts.torch_port_reference import CannedSession

    with open(LLM_ROUTE) as f:
        ref = json.load(f)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    made = extractor_module._new_http_session
    sessions = []
    extractor_module._new_http_session = lambda: sessions.append(
        CannedSession(ref["replies"], ref["models"]["gemini"])) or sessions[-1]
    try:
        with llm_env(ref["env"]), watch_llm_calls():
            t0 = time.perf_counter()
            process_book.main(["1", "--llm-backend", "ollama", "--output-dir", os.path.join(tmp, "pb")])
            with open(os.path.join(tmp, "pb", "book_1_enhanced.json")) as f:
                saved = json.load(f)
            if saved["title"] != "Fenced Title" or len(sessions[-1].posts) != 2:
                fail(f"process_book --llm-backend ollama wrote {saved.get('title')!r} after "
                     f"{len(sessions[-1].posts)} requests (warm-up and one generate expected)")
            print(f"process_book --llm-backend ollama: {time.perf_counter() - t0:.3f} s; {card}", flush=True)
        fields = []
        for workers in (1, 2):
            out = os.path.join(tmp, f"batch{workers}")
            t0 = time.perf_counter()
            # float32: with 2 workers BatchingOCR coalesces both books' photos
            # into one batch, and a bfloat16 batch of 2 reads otherwise than
            # two of 1 (PERF.md, PR 12)
            with float32_engines():
                summary = batch.main(["--books-dir", BOOKS_DIR, "--book-ids", "1", "2", "3", "--max-workers",
                                      str(workers), "--llm-backend", "heuristic", "--output-dir", out])
            if summary["succeeded"] != 3 or summary["failed"]:
                fail(f"batch with {workers} workers: {json.dumps(summary['results'])}")
            books = {}
            for b in ("1", "2", "3"):
                with open(os.path.join(out, f"book_{b}_enhanced.json")) as f:
                    books[b] = {k: v for k, v in json.load(f).items() if not k.startswith("_")}
            fields.append(books)
            print(f"batch --max-workers {workers}: 3 books in {time.perf_counter() - t0:.3f} s; {card}", flush=True)
        if fields[0] != fields[1]:
            fail(f"batch: the fields differ between 1 and 2 workers: {fields}")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = smoke.main(["--books-dir", BOOKS_DIR, "--llm-backend", "heuristic"])
        if rc != 0 or "SMOKE PASS" not in printed.getvalue():
            fail(f"smoke --books-dir books: rc {rc}: {printed.getvalue()[-2000:]}")
        print("smoke --books-dir books: SMOKE PASS", flush=True)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            profile_engine.main(["--photos", "4", "--repeat", "2"])
        lines = printed.getvalue().splitlines()
        if len(lines) != 7 or "stages" not in json.loads(lines[1]):
            fail(f"profile_engine printed {lines}")
        print("profile_engine --photos 4 --repeat 2:\n  " + "\n  ".join(lines) + f"\n  {card}", flush=True)
    finally:
        extractor_module._new_http_session = made
        close_shared_engines()
        shutil.rmtree(tmp, ignore_errors=True)


def job_differences(got: dict, want: dict) -> list:
    """Where a service job's record (``job_record`` of
    ``scripts/torch_port_reference.py``) differs from the reference's: its
    status, metadata and trace steps, and each LLM request's URL, headers,
    timeout, body, prompt and cover JPEG (the OCR'd photos' JPEGs aside:
    the card's chain and the CPU's differ on a few pixels)."""
    bad = [k for k in ("status", "error", "meta", "steps") if got.get(k) != want.get(k)]
    posts, want_posts = got.get("posts", []), want.get("posts", [])
    if len(posts) != len(want_posts):
        return bad + ["posts"]
    for i, (g, w) in enumerate(zip(posts, want_posts)):
        bad += [f"post {i} {k}" for k in ("url", "headers", "timeout", "body", "prompt") if g[k] != w[k]]
        if g["image_sha256"][:1] != w["image_sha256"][:1]:
            bad.append(f"post {i} cover JPEG")
    return bad


@contextlib.contextmanager
def watch_warmup():
    """Within the block every ``OCREngine.warmup`` call is listed (its
    return value once it ends) and an exception in it recorded, so that the
    run fails at the next phase although the service's warm-up thread
    swallows it."""
    calls = []
    warmup = OCREngine.__dict__["warmup"]
    recorded = _recorded("OCREngine.warmup", warmup)

    def listed(self, *args, **kw):
        calls.append("started")
        calls.append(recorded(self, *args, **kw))
        return calls[-1]

    OCREngine.warmup = listed
    try:
        yield calls
    finally:
        OCREngine.warmup = warmup


def check_service(dev, card) -> dict:
    """12: the port's scanner service on the card, served on 127.0.0.1 and
    driven with the standard library's HTTP client only: the engine's
    warm-up at startup (``BB_OCR_ENGINE_WARMUP=1``), jobs on ``books/1`` to
    ``books/3`` for the heuristic and ollama backends (canned session),
    float32, each job's metadata, steps and LLM request equal to the JAX
    service's (``tests/data/server_route_jax_f32.json``) and every kernel
    launched twice per job; then the review and pricing requests and the
    pricing CLI through canned clients, equal to ``pricing_jax.json``, and
    the stdlib AbeBooks parser on every recorded page. While a job runs the
    service sends every print of the process into the job's log, so nothing
    is printed until the service has shut down."""
    import io
    import shutil
    import tempfile

    from bbocr_tpu_torch.cli import pricing as pricing_cli
    from bbocr_tpu_torch.pricing.providers import abebooks_html, google_books
    from bbocr_tpu_torch.server.app import ScannerService
    from scripts.torch_port_reference import (
        LLM_MODELS, CannedHttp, CannedSession, ServiceThread, http_json, pricing_flow, server_jobs, wait_jobs_idle)

    if os.environ.get("BB_OCR_BATCHING") is not None:
        fail("BB_OCR_BATCHING is set: phase 12 serves the default wrapping")
    with open(SERVER_ROUTE) as f:
        ref = json.load(f)
    with open(PRICING_REFERENCE) as f:
        pref = json.load(f)
    parse_bad = [(c["page"], c["query"]) for c in pref["parses"]
                 if abebooks_html.parse_results_html(pref["pages"][c["page"]], **c["query"]) != c["offers"]]
    session = CannedSession(ref["replies"], LLM_MODELS["gemini"])
    http = CannedHttp(pref["google_payload"], {kn: pref["pages"][name] for kn, name in pref["lookup_pages"].items()})
    clients = google_books._async_client, abebooks_html._async_client
    google_books._async_client = abebooks_html._async_client = http
    warm_env = os.environ.get("BB_OCR_ENGINE_WARMUP")
    os.environ["BB_OCR_ENGINE_WARMUP"] = "1"
    out, err = sys.stdout, sys.stderr
    tmp = tempfile.mkdtemp(prefix="chip_smoke_service_")
    try:
        with float32_engines(), watch_warmup() as warm_calls:
            t0 = time.perf_counter()
            service = ScannerService(data_dir=tmp, books_dir=BOOKS_DIR, device=dev, session=session)
            with ServiceThread(service) as srv:
                while len(warm_calls) < 2 and not SWALLOWED and time.perf_counter() - t0 < 600:
                    time.sleep(0.05)
                warm_s = time.perf_counter() - t0
                _, health = http_json(srv.base, "GET", "/api/health")
                kernels.reset_launches()
                records, jobs = server_jobs(srv.base, session, ref["books"], ref["backends"])
                torch.cuda.synchronize()
                launches = {name: fn.launches for name, fn in kernels.KERNELS.items()}
                idle = wait_jobs_idle(service)
                while (sys.stdout is not out or sys.stderr is not err) and time.perf_counter() - t0 < 900:
                    time.sleep(0.01)  # the last job's runner puts the streams back after its status
                sys.stdout, sys.stderr = out, err
                accepted = records["ollama"]["1"].get("meta", {})
                flow = pricing_flow(srv.base, accepted, tmp)
                printed = io.StringIO()
                with contextlib.redirect_stdout(printed):
                    pricing_cli.main(["--from-json", os.path.join(service.accepted_dir, "book_1_ollama.json"),
                                      "--select"])
                _, metrics = http_json(srv.base, "GET", "/api/metrics")
    finally:
        sys.stdout, sys.stderr = out, err
        google_books._async_client, abebooks_html._async_client = clients
        if warm_env is None:
            os.environ.pop("BB_OCR_ENGINE_WARMUP", None)
        else:
            os.environ["BB_OCR_ENGINE_WARMUP"] = warm_env
        shutil.rmtree(tmp, ignore_errors=True)
    n_jobs = len(ref["books"]) * len(ref["backends"])
    runs = [(b, k, jobs[b][k], records[b][k]) for b in ref["backends"] for k in ref["books"]]
    seconds = [job.get("seconds", float("nan")) for *_, job, _ in runs]
    print(f"service: warm-up {warm_calls[1:]} calls in {warm_s:.3f} s after startup; health {json.dumps(health)}; "
          f"{n_jobs} jobs, seconds per job first {seconds[0]:.3f}, then median {statistics.median(seconds[1:]):.3f} "
          f"(max {max(seconds[1:]):.3f}); launches {json.dumps(launches)}; {card}", flush=True)
    failed = []
    for backend, book, job, record in runs:
        bad = job_differences(record, ref["runs"][backend][book])
        ocr_failed = [line for line in job.get("logs", []) if "OCR failed:" in line]
        first = job.get("first_trace_s")
        print(f"  {backend} book {book}: {job.get('statuses')}, {job.get('seconds', float('nan')):.3f} s, first "
              f"trace frame {'none' if first is None else f'{first:.3f} s'} after posting, {job.get('trace_frames')} "
              f"trace frames, {len(job.get('logs', []))} log lines; "
              f"{'equal to JAX' if not bad else 'DIFFERS in ' + ', '.join(bad)}", flush=True)
        for line in ocr_failed:
            print(f"    log: {line}", flush=True)
        g, w = record.get("posts", []), ref["runs"][backend][book]["posts"]
        if g and len(g) == len(w) and g[-1]["image_sha256"][1:] != w[-1]["image_sha256"][1:]:
            print("    the OCR'd photos' JPEGs differ from JAX's (preprocessed on the card; not required)", flush=True)
        if bad or ocr_failed or record.get("status") != "done" or not job.get("trace_frames"):
            failed.append((backend, book))
            print(f"    got  {json.dumps(record)[:3000]}\n    JAX  {json.dumps(ref['runs'][backend][book])[:3000]}",
                  flush=True)
    flow_bad = [k for k in pref["service"] if flow.get(k) != pref["service"][k]]
    cli = json.loads(printed.getvalue())
    requests_equal = sorted(map(json.dumps, http.requests)) == sorted(map(json.dumps, pref["requests"]))
    lookup = flow["pricing_lookup"]["body"]
    print(f"pricing: {len(lookup['offers'])} offers, errors {json.dumps(lookup['errors'])}, best "
          f"{flow['select_best']['body']['reason']}; service responses {'equal' if not flow_bad else 'DIFFER in ' + str(flow_bad)}"
          f", CLI {'equal' if cli == pref['cli'] else 'DIFFERS'}, requests {'equal' if requests_equal else 'DIFFER'}; "
          f"the stdlib AbeBooks parser on {len(pref['parses'])} recorded pages and queries: "
          f"{'equal' if not parse_bad else 'DIFFERS on ' + str(parse_bad)}; engine timings "
          f"{json.dumps({k: round(v['total_s'], 3) for k, v in metrics['engine_timings'].items()})} s; {card}", flush=True)
    for k in flow_bad:
        print(f"    {k}: got {json.dumps(flow.get(k))[:2000]}\n    JAX {json.dumps(pref['service'][k])[:2000]}", flush=True)
    if len(warm_calls) < 2 or warm_calls[1] != 1 + len(EngineConfig().canvases):
        fail(f"the service's engine warm-up did not run to its end: {warm_calls}, {SWALLOWED[:3]}")
    if not (health.get("pipeline_imported") and health.get("pricing_available")):
        fail(f"/api/health: {health}")
    if not idle or failed:
        fail(f"service jobs differ from the JAX service's or failed: {failed} (all ended: {idle})")
    for name, count in launches.items():
        if count != 2 * n_jobs:
            fail(f"kernel {name} launched {count} times by {n_jobs} service jobs (2 per job expected)")
    if flow_bad or cli != pref["cli"] or not requests_equal or parse_bad:
        fail(f"pricing differs from the JAX package's: responses {flow_bad}, CLI {cli != pref['cli']}, requests "
             f"{not requests_equal}, parses {parse_bad}")
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the PageReader (models/vlm.py, llm/native_vlm.py)
# ---------------------------------------------------------------------------

VLM_REFERENCE = {dt: os.path.join(ROOT, "tests", "data", f"vlm_jax_{dt}.json") for dt in ("f32", "bf16")}
VLM_CKPT = os.path.join(CKPT, "vlm.npz")
VLM_MARGIN = 1e-4
# Greedy readings of the card in float32 that differ from the JAX package's
# float32 CPU run, each where JAX's top-2 logit margin at the first
# differing step is below VLM_MARGIN: (page, first differing slot).
KNOWN_VLM_READINGS: set = set()


def vlm_reference(dt: str) -> tuple:
    """(the recorded JAX run of ``scripts/torch_port_reference.py --vlm``,
    its teacher-forced logits per page)."""
    with open(VLM_REFERENCE[dt]) as f:
        ref = json.load(f)
    with np.load(os.path.join(os.path.dirname(VLM_REFERENCE[dt]), ref["logits_file"])) as lg:
        return ref, [lg[f"page{i}"] for i in range(len(ref["pages"]))]


@functools.lru_cache(maxsize=None)
def vlm_page(rel: str, dev) -> torch.Tensor:
    """A repository image as the client loads it, (1, 256, 192, 1) on ``dev``
    (loaded once: phases 13a, 13b and 13e read the same pages)."""
    import base64

    from bbocr_tpu_torch.llm.native_vlm import NativeVLMClient

    with open(os.path.join(ROOT, rel), "rb") as f:
        page = NativeVLMClient._page_from_b64(base64.b64encode(f.read()).decode())
    return torch.from_numpy(page)[None, ..., None].to(dev)


def vlm_model(dev, dtype) -> torch.nn.Module:
    from bbocr_tpu_torch.models.vlm import PageReader
    from bbocr_tpu_torch.utils.checkpoint import load_params

    return PageReader(dtype=dtype).load_params(load_params(VLM_CKPT)).to(dev).eval()


def top2_margin(row: np.ndarray) -> float:
    top = np.sort(row)[-2:]
    return float(top[1] - top[0])


def timed_greedy(model, page) -> tuple:
    """(ids on the host, seconds of one synchronised greedy decode)."""
    from bbocr_tpu_torch.models.vlm import greedy_generate

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = greedy_generate(model, page)
    torch.cuda.synchronize()
    return ids[0].cpu().tolist(), time.perf_counter() - t0


def check_vlm_float32(dev, card) -> list:
    """13(a): the shipped checkpoint in float32 (TF32 off) on the 24 pages
    of the reference: each greedy reading equal to the JAX package's float32
    CPU run, or a pinned reading (``KNOWN_VLM_READINGS``) whose JAX top-2
    margin at the first differing step is below 1e-4; the teacher-forced
    logits on JAX's ids printed against JAX's. Returns the greedy seconds."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref, ref_logits = vlm_reference("f32")
    model = vlm_model(dev, torch.float32)
    failed, seconds, worst = [], [], 0.0
    for p, want_logits in zip(ref["pages"], ref_logits):
        page = vlm_page(p["page"], dev)
        ids, s = timed_greedy(model, page)
        seconds.append(s)
        with torch.no_grad():
            forced = model(page, torch.tensor([p["ids"]], device=dev))[0, : p["steps"]].cpu().numpy()
        diff = float(np.abs(forced - want_logits).max())
        worst = max(worst, diff)
        if ids == p["ids"]:
            print(f"  {p['page']}: equal to JAX ({p['steps']} steps, forced logits within {diff:.3g}; {s:.3f} s)",
                  flush=True)
            continue
        slot = next(i for i, (a, b) in enumerate(zip(ids, p["ids"])) if a != b)
        margin, card_margin = top2_margin(want_logits[slot - 1]), top2_margin(forced[slot - 1])
        known = (p["page"], slot) in KNOWN_VLM_READINGS and margin < VLM_MARGIN
        print(f"  {p['page']}: DIFFERS from JAX first at slot {slot} ({ids[slot]} against {p['ids'][slot]}); JAX's "
              f"top-2 margin there {margin:.3g}, the card's {card_margin:.3g}; {'pinned' if known else 'not pinned'}",
              flush=True)
        if not known:
            failed.append((p["page"], slot, margin))
    print(f"13a float32: {len(ref['pages']) - len(failed)} of {len(ref['pages'])} pages as JAX or pinned; forced "
          f"logits within {worst:.3g} of JAX's; greedy decode {statistics.median(seconds):.3f} s per page (median, "
          f"first {seconds[0]:.3f}); {card}", flush=True)
    if failed:
        fail(f"the card's float32 PageReader reads otherwise than JAX's: {failed}")
    return seconds


@contextlib.contextmanager
def recorded_greedy(record: list):
    """Within the block every ``models.vlm.greedy_generate`` call appends
    (its ids on the host, its seconds) to ``record``."""
    from bbocr_tpu_torch.models import vlm as vlm_module

    greedy = vlm_module.greedy_generate

    def recording(model, page, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = greedy(model, page, *args, **kw)
        torch.cuda.synchronize()
        record.append((ids.cpu().tolist(), time.perf_counter() - t0))
        return ids

    vlm_module.greedy_generate = recording
    try:
        yield record
    finally:
        vlm_module.greedy_generate = greedy


def check_vlm_bfloat16(dev, card) -> list:
    """13(b) and 13(d): the client's bfloat16 on the same pages, printed
    against the JAX package's bfloat16 CPU run: ``vlm_eval --real`` (the
    CLI, on the card) reads the first 21, the last three are read directly;
    token agreement per page and the largest logit difference of a
    teacher-forced pass on JAX's ids. Then the ``--real`` report beside
    JAX's. Returns the greedy seconds."""
    from bbocr_tpu_torch.cli import vlm_eval
    from bbocr_tpu_torch.models import vlm as vlm_module

    ref, ref_logits = vlm_reference("bf16")
    record: list = []
    with recorded_greedy(record):
        report = vlm_eval.main(["--real", "--device", str(dev), "--real-dir", REAL_DIR, "--ckpt", VLM_CKPT])["real"]
        model = vlm_model(dev, torch.bfloat16)
        for p in ref["pages"][len(record):]:
            vlm_module.greedy_generate(model, vlm_page(p["page"], dev))
    if len(record) != len(ref["pages"]):
        fail(f"13b read {len(record)} pages, the reference has {len(ref['pages'])}")
    equal, worst = 0, 0.0
    for p, want_logits, (ids, _) in zip(ref["pages"], ref_logits, record):
        with torch.no_grad():
            forced = model(vlm_page(p["page"], dev), torch.tensor([p["ids"]], device=dev))[0, : p["steps"]]
        diff = float(np.abs(forced.cpu().numpy() - want_logits).max())
        worst = max(worst, diff)
        same = ids[0] == p["ids"]
        equal += same
        agree = sum(a == b for a, b in zip(ids[0], p["ids"]))
        print(f"  {p['page']}: {'equal to' if same else 'differs from'} JAX's bfloat16 ids ({agree} of "
              f"{len(p['ids'])} slots), forced logits within {diff:.3g}", flush=True)
    seconds = [s for _, s in record]
    print(f"13b bfloat16: {equal} of {len(record)} pages read as JAX's bfloat16 CPU run; forced logits within "
          f"{worst:.3g}; greedy decode {statistics.median(seconds):.3f} s per page (median, first {seconds[0]:.3f}); "
          f"{card}", flush=True)
    want = ref["eval_real"]
    print(f"13d vlm_eval --real, bfloat16: books {report['books']}, fields {report['fields']}, exact "
          f"{report['exact_acc']}, fuzzy {report['fuzzy_acc']} (JAX bfloat16 on the CPU: books {want['books']}, "
          f"fields {want['fields']}, exact {want['exact_acc']}, fuzzy {want['fuzzy_acc']}); rows "
          f"{'equal' if report['rows'] == want['rows'] else 'differ'}; {card}", flush=True)
    if report["books"] != want["books"] or report["fields"] != want["fields"]:
        fail(f"vlm_eval --real scored {report['books']} books and {report['fields']} fields, JAX "
             f"{want['books']} and {want['fields']}")
    return seconds


def tpu_route_meta(meta: dict) -> dict:
    meta = dict(meta)
    info = dict(meta.pop("_processing_info"))
    for key in ("engine_timings", "ocr_boxes"):
        info.pop(key, None)
    return {**meta, "_processing_info": info}


def check_tpu_route(dev, card) -> dict:
    """13(c): the no-engine extractor with ``llm_backend="tpu"`` on
    ``books/1`` to ``books/3`` and one service job (``llm_backend=tpu``,
    ``model=checkpoints/vlm.npz``, as the UI posts it) on ``books/1``, the
    cached client's model a float32 PageReader (``client._model``) and the
    shared engine float32: the metadata equal to the JAX extractor's
    recorded run, each kernel launched once per OCR'd photo (two per book).
    Then one book with the client's default bfloat16 model, timed."""
    import shutil
    import tempfile

    from bbocr_tpu_torch.llm import native_vlm
    from bbocr_tpu_torch.models.vlm import PageReader
    from bbocr_tpu_torch.server.app import ScannerService
    from scripts.torch_port_reference import ServiceThread, book_images, job_record, run_job, wait_jobs_idle

    if os.environ.get("BB_OCR_BATCHING") is not None:
        fail("BB_OCR_BATCHING is set: phase 13 runs the default wrapping")
    ref, _ = vlm_reference("f32")
    route = ref["route"]
    cwd = os.getcwd()
    os.chdir(ROOT)  # the client resolves checkpoints/vlm.npz, as the UI names it, from the working directory
    native_vlm._CLIENT_CACHE.clear()
    client = native_vlm.get_native_client(device=dev)
    client._model = PageReader(dtype=torch.float32)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vlm_")
    out, err = sys.stdout, sys.stderr
    try:
        with float32_engines():
            ext = BookMetadataExtractor(llm_backend="tpu", warm_model=False, device=dev)
            kernels.reset_launches()
            metas, seconds = {}, []
            for book in route["books"]:
                t0 = time.perf_counter()
                metas[book] = ext.process_book_directory(os.path.join(BOOKS_DIR, book))
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            launches = {name: fn.launches for name, fn in kernels.KERNELS.items()}
            kernels.reset_launches()
            service = ScannerService(data_dir=tmp, books_dir=BOOKS_DIR, device=dev)
            with ServiceThread(service) as srv:
                t0 = time.perf_counter()
                job = run_job(srv.base, book_images("1"), {"llm_backend": "tpu", "model": native_vlm.DEFAULT_CKPT,
                                                           "run_ocr": "true"})
                idle = wait_jobs_idle(service)
                while (sys.stdout is not out or sys.stderr is not err) and time.perf_counter() - t0 < 900:
                    time.sleep(0.01)  # the job's runner puts the streams back after its status
            sys.stdout, sys.stderr = out, err
            torch.cuda.synchronize()
            job_launches = {name: fn.launches for name, fn in kernels.KERNELS.items()}
            client._model = PageReader()  # the client's default, bfloat16
            t0 = time.perf_counter()
            bf16_meta = ext.process_book_directory(os.path.join(BOOKS_DIR, "1"))
            torch.cuda.synchronize()
            bf16_seconds = time.perf_counter() - t0
    finally:
        sys.stdout, sys.stderr = out, err
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    failed = []
    for book, s in zip(route["books"], seconds):
        got, want = tpu_route_meta(metas[book]), route["runs"][book]
        print(f"  tpu route book {book}: {'equal to JAX' if got == want else 'DIFFERS from JAX'}; {s:.3f} s; "
              f"{json.dumps({k: v for k, v in got.items() if not k.startswith('_')})}", flush=True)
        if got != want:
            failed.append(book)
            print(f"    got {json.dumps(got)}\n    JAX {json.dumps(want)}", flush=True)
    record = job_record(job, []) if "result" in job else job
    want = dict(route["runs"]["1"])
    want["_processing_info"] = {**want["_processing_info"], "model_used": native_vlm.DEFAULT_CKPT}
    job_meta = record.get("meta")
    if job_meta is not None:
        job_meta = tpu_route_meta(job_meta)
    print(f"  service job (tpu, {native_vlm.DEFAULT_CKPT}) on book 1: {record.get('status')}, "
          f"{job.get('seconds', float('nan')):.3f} s, {'equal to JAX' if job_meta == want else 'DIFFERS from JAX'}",
          flush=True)
    print(f"13c: launches on the route {json.dumps(launches)}, on the job {json.dumps(job_launches)}; a bfloat16 book "
          f"{bf16_seconds:.3f} s ({json.dumps({k: v for k, v in bf16_meta.items() if not k.startswith('_')})}); "
          f"{card}", flush=True)
    if failed or job_meta != want or not idle:
        fail(f"the tpu route differs from the JAX extractor's: books {failed}, job {record} (all ended: {idle})")
    n_route = 2 * len(route["books"])
    for name in launches:
        if launches[name] != n_route or job_launches[name] != 2:
            fail(f"kernel {name} launched {launches[name]} times by the route ({n_route} expected) and "
                 f"{job_launches[name]} by the job (2 expected)")
    return {name: launches[name] + job_launches[name] for name in launches}


def time_vlm(dev, card, f32_seconds, bf16_seconds) -> None:
    """13(e): the client's bfloat16 model on a cover: the encoder between
    CUDA events; the greedy decode's first call and warm median (13b's
    decodes; float32's from 13a); one warm decode timed on the host, then
    one under torch.profiler (device ms, kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bbocr_tpu_torch.models.vlm import greedy_generate

    model = vlm_model(dev, torch.bfloat16)
    page = vlm_page("data/real/covers/book1.png", dev)
    with torch.no_grad():
        enc = median_ms(lambda: model.encode(page))
    _, host = timed_greedy(model, page)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        greedy_generate(model, page)
        torch.cuda.synchronize()
    run = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device = sum(e.time_range.end - e.time_range.start for e in run) / 1e3
    print(f"13e: encoder {enc:.3f} ms; greedy decode bfloat16 first {bf16_seconds[0]:.3f} s, warm median "
          f"{statistics.median(bf16_seconds[1:]):.3f} s (float32: first {f32_seconds[0]:.3f} s, warm median "
          f"{statistics.median(f32_seconds[1:]):.3f} s); one warm decode of book1.png: {host * 1e3:.1f} ms host, "
          f"{device:.1f} ms device in {len(run)} kernels ({len(run) / 191:.0f} per step; device idle "
          f"{100 * (1 - device / (host * 1e3)):.1f} %); {card}", flush=True)


# One recorded batch per component from the JAX generators, and the JAX
# package's three steps of each step maker on them from the shipped
# checkpoints, float32 and bfloat16 (scripts/torch_port_reference.py --train)
TRAIN_BATCHES = os.path.join(ROOT, "tests", "data", "train_batches.npz")
TRAIN_REFERENCE = {dt: os.path.join(ROOT, "tests", "data", f"train_jax_{dt}.json") for dt in ("f32", "bf16")}
TRAIN_REL = 1e-4  # losses and the step-1 gradient norm, relative
TRAIN_ABS = 1e-4  # parameters after step 3, absolute
SMALL_GRAD = 1e-6  # below it, Adam's first update takes its sign from rounding
TRAIN_BF16_REL = 0.02  # bfloat16 losses against the JAX package's bfloat16 CPU run, relative (the CPU: 0.0064)
TRAIN_COMPONENTS = ("crnn", "craft", "vlm")


def train_runs(dev, dtype) -> dict:
    """name -> (model, float32 params on ``dev``, loss_fn, step maker's
    step, batch) for the three recorded runs, in the compute ``dtype``."""
    from bbocr_tpu_torch.models import CRAFT, CRNN, PageReader
    from bbocr_tpu_torch.train import TrainConfig, make_optimizer
    from bbocr_tpu_torch.train import trainer
    from bbocr_tpu_torch.utils.checkpoint import load_params

    with open(TRAIN_REFERENCE["f32"]) as f:
        ref = json.load(f)
    with np.load(TRAIN_BATCHES) as data:
        b = {k: torch.from_numpy(data[k]).to(dev) for k in data.files}
    cfg = TrainConfig(**ref["config"])
    vlm_tree = load_params(VLM_CKPT)
    vlm_tree["params"]["ctc_head"] = {"kernel": b["vlm_ctc_head_kernel"].cpu().numpy(),
                                      "bias": b["vlm_ctc_head_bias"].cpu().numpy()}
    crnn, craft, reader = CRNN(num_classes=97).to(dev), CRAFT().to(dev), PageReader(dtype=dtype).to(dev)
    weight = ref["ctc_weight"]
    runs = {
        "crnn": (crnn, load_params(os.path.join(CKPT, "crnn.npz")),
                 lambda p, *x: trainer.crnn_loss(crnn, p, *x, dtype=dtype),
                 lambda tx: trainer.make_crnn_train_step(crnn, tx, dtype=dtype),
                 ("crnn_crops", "crnn_labels", "crnn_label_lens", "crnn_frame_lens")),
        "craft": (craft, load_params(os.path.join(CKPT, "craft.npz")),
                  lambda p, *x: trainer.craft_loss(craft, p, *x, dtype=dtype),
                  lambda tx: trainer.make_craft_train_step(craft, tx, dtype=dtype),
                  ("craft_pages", "craft_maps")),
        "vlm": (reader, vlm_tree,
                lambda p, pages, tokens, lens, chars, char_lens: trainer.vlm_loss(reader, p, pages, tokens, lens)
                + weight * trainer.vlm_ctc_aux_loss(reader, p, pages, chars, char_lens),
                lambda tx: trainer.make_vlm_train_step(reader, tx, ctc_weight=weight),
                ("vlm_pages", "vlm_tokens", "vlm_tok_lens", "vlm_char_labels", "vlm_char_lens")),
    }
    out = {}
    for name, (model, tree, loss_fn, make_step, keys) in runs.items():
        tx = make_optimizer(cfg)
        batch = tuple(b[k] for k in keys)
        out[name] = (model, trainer.to_params(model, tree, dev), tx, make_step(tx), loss_fn, batch)
    return out


def run_train(model, params, tx, step, loss_fn, batch, steps: int):
    """(losses, step-1 gradient norm, step-1 gradients, params after the
    steps, seconds per step) of ``steps`` steps from ``params``."""
    from bbocr_tpu_torch.train.optim import global_norm
    from bbocr_tpu_torch.train.trainer import value_and_grad

    opt_state = tx.init(params)
    _, _, grads = value_and_grad(lambda p: loss_fn(p, *batch), params)
    norm = float(global_norm(grads))
    losses, seconds = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, *batch)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
    return losses, norm, grads, params, seconds


def check_train_float32(dev, card) -> dict:
    """14(a): the three step makers in float32 (TF32 off) at full width on
    the recorded batches, held to the JAX package's float32 CPU run: each
    loss and the step-1 gradient norm within ``TRAIN_REL`` relative, the
    recorded elements of every parameter after step 3 within ``TRAIN_ABS``
    except where Adam's first update takes its sign from rounding: where a
    step-1 gradient (the card's or JAX's) is below ``SMALL_GRAD`` in
    magnitude, or where the two have opposite signs (the step-1 rate is 0,
    so step 2 sees the same gradient and moves each element by about the
    rate in its sign; both kinds counted and printed). Per leaf, the sum's
    difference is printed. Returns seconds per step by component."""
    from bbocr_tpu_torch.train.trainer import to_tree

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(TRAIN_REFERENCE["f32"]) as f:
        ref = json.load(f)
    samples = np.load(os.path.join(ROOT, "tests", "data", ref["samples_file"]))
    problems, seconds = [], {}
    for name, (model, params, tx, step, loss_fn, batch) in train_runs(dev, torch.float32).items():
        want = ref["components"][name]
        losses, norm, grads, after, secs = run_train(model, params, tx, step, loss_fn, batch, ref["steps"])
        seconds[name] = secs
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want["losses"]))
        norm_err = abs(norm - want["grad_norm_1"]) / want["grad_norm_1"]
        got = dict(_tree_leaves(to_tree(model, after)))
        got_g = dict(_tree_leaves(to_tree(model, grads)))
        worst, exempt, flips, n, sum_err = 0.0, 0, 0, 0, 0.0
        for path, leaf in want["leaves"].items():
            idx = samples[f"{name}/{path}/idx"]
            p_ref, g_ref = samples[f"{name}/{path}/params"], samples[f"{name}/{path}/grad1"]
            p_got, g_got = got[path].ravel()[idx], got_g[path].ravel()[idx]
            small = (np.abs(g_ref) < SMALL_GRAD) | (np.abs(g_got) < SMALL_GRAD)
            flipped = ~small & (np.sign(g_ref) != np.sign(g_got))
            exempt += int(small.sum())
            flips += int(flipped.sum())
            n += idx.size
            keep = ~(small | flipped)
            if keep.any():
                worst = max(worst, float(np.abs(p_got - p_ref)[keep].max()))
            sum_err = max(sum_err, abs(float(got[path].astype(np.float64).sum()) - leaf["sum"]) / leaf["size"])
        print(f"14a {name}: losses {losses} (JAX {want['losses']}, worst relative {loss_err:.3g}); step-1 gradient "
              f"norm {norm:.7g} (JAX {want['grad_norm_1']:.7g}, relative {norm_err:.3g}); parameters after step "
              f"{ref['steps']}: {n} recorded elements, worst {worst:.3g} where both step-1 gradients reach "
              f"{SMALL_GRAD:g} and agree in sign, {exempt} exempt below {SMALL_GRAD:g}, {flips} exempt with "
              f"step-1 gradients of opposite signs; per-leaf sums differ by at most {sum_err:.3g} per element; "
              f"seconds per step {[round(x, 3) for x in secs]}; {card}", flush=True)
        if not (loss_err <= TRAIN_REL and norm_err <= TRAIN_REL and worst <= TRAIN_ABS):
            problems.append(f"{name}: loss {loss_err:.3g}, gradient norm {norm_err:.3g}, parameters {worst:.3g}")
    if problems:
        fail(f"float32 training differs from the JAX package's: {problems}")
    return seconds


def _tree_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _tree_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(tree[k])


def check_train_bfloat16(dev, card) -> dict:
    """14(b): the same three runs computing in bfloat16 (the trainer's
    default), printed beside the JAX package's bfloat16 CPU run; every loss
    must be finite and within ``TRAIN_BF16_REL`` of JAX's. Returns the
    runs for 14(d)."""
    with open(TRAIN_REFERENCE["bf16"]) as f:
        ref = json.load(f)
    runs = train_runs(dev, torch.bfloat16)
    problems = []
    for name, (model, params, tx, step, loss_fn, batch) in runs.items():
        want = ref["components"][name]
        losses, norm, _, _, secs = run_train(model, params, tx, step, loss_fn, batch, ref["steps"])
        err = max(abs(a - b) / abs(b) for a, b in zip(losses, want["losses"]))
        print(f"14b {name}: bfloat16 losses {losses} (JAX bfloat16 {want['losses']}, worst relative {err:.3g}); "
              f"step-1 gradient norm {norm:.6g} (JAX {want['grad_norm_1']:.6g}); seconds per step "
              f"{[round(x, 3) for x in secs]}; {card}", flush=True)
        if not all(math.isfinite(x) for x in losses) or err > TRAIN_BF16_REL:
            problems.append(f"{name}: {losses} against {want['losses']}")
    if problems:
        fail(f"bfloat16 training losses not finite or beyond {TRAIN_BF16_REL} of JAX's: {problems}")
    return runs


def check_train_cli(dev, card) -> None:
    """14(c): ``cli/train.py``'s recognizer loop on the card on the recorded
    batch (from ``checkpoints/crnn.npz``): 2 steps saving the state at step
    2, then a resume to step 4; the saved ``crnn.npz`` loads in
    ``OCREngine.from_checkpoint`` and reads ``book1.png`` through the
    extractor, each kernel launched; ``OCREngine.create()`` reads a photo."""
    import shutil
    import tempfile

    from bbocr_tpu_torch.cli import train as train_cli
    from bbocr_tpu_torch.models.charset import EN_CHARSET

    with np.load(TRAIN_BATCHES) as data:
        batch = tuple(data[k] for k in ("crnn_crops", "crnn_labels", "crnn_label_lens", "crnn_frame_lens"))
    refs = [EN_CHARSET.decode_ids(batch[1][i][: batch[2][i]]) for i in range(8)]
    out = tempfile.mkdtemp(prefix="train_cli_")
    try:
        flags = ["--component", "crnn", "--batch", "32", "--width", "256", "--out", out, "--state-dir",
                 os.path.join(out, "state"), "--save-every", "2", "--log-every", "2", "--device", str(dev),
                 "--init-from", os.path.join(CKPT, "crnn.npz")]
        first = train_cli.train_crnn(train_cli.build_parser().parse_args(flags + ["--steps", "2"]),
                                     source=train_cli.Batches([batch]), val=(batch[0][:8], refs))
        second = train_cli.train_crnn(train_cli.build_parser().parse_args(flags + ["--steps", "4"]),
                                      source=train_cli.Batches([batch]), val=(batch[0][:8], refs))
        saved = sorted(os.listdir(os.path.join(out, "state")))
        print(f"14c: first run {first['log']}; resumed at step {second['start_step']}: {second['log']}; "
              f"states {saved}; {card}", flush=True)
        if second["start_step"] != 2 or [r["step"] for r in second["log"]] != [4] or "step_4" not in saved:
            fail(f"the CLI loop did not resume from step 2 to step 4: {second}, states {saved}")
        engine = OCREngine.from_checkpoint(os.path.join(CKPT, "craft.npz"), second["path"], device=dev)
        extractor = BookMetadataExtractor(llm_backend="heuristic", engine=engine, device=dev)
        kernels.reset_launches()
        meta = extractor.extract_metadata_from_images([BOOK1], ocr_image_indices=[0])
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in kernels.KERNELS.items()}
        print(f"14c: book1.png with the trained crnn.npz: {meta['_processing_info']['ocr_boxes']} boxes, "
              f"title {meta.get('title')!r}; launches {launches}", flush=True)
        if min(launches.values()) < 1 or meta["_processing_info"]["ocr_boxes"] < 1:
            fail(f"the trained checkpoint's read of book1.png launched {launches} and found "
                 f"{meta['_processing_info']['ocr_boxes']} boxes")
        fresh = OCREngine.create(device=dev)
        results = fresh.readtext(load_rgb(BOOK1))
        torch.cuda.synchronize()
        print(f"14c: OCREngine.create() read book1.png: {len(results)} boxes (untrained weights)", flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def time_train(runs, card) -> None:
    """14(d): one bfloat16 step of each component: seconds per step (median
    of 3 after one warm step), host ms of one synchronised step, device ms
    and kernels from torch.profiler, peak device memory over a step, and
    crops or pages per second."""
    for name, (model, params, tx, step, loss_fn, batch) in runs.items():
        opt_state = tx.init(params)
        call = functools.partial(step, params, opt_state, *batch)
        call()
        torch.cuda.synchronize()
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()
        host, device, count = profile_call(call)
        peak = torch.cuda.max_memory_allocated() / 2**30
        rows = batch[0].shape[0]
        unit = "crops" if name == "crnn" else "pages"
        median = statistics.median(secs)
        print(f"14d {name}: bfloat16 step {median:.4f} s (median of {[round(x, 4) for x in secs]}), "
              f"{rows / median:.1f} {unit}/s; one step {host:.1f} ms host, {device:.1f} ms device in {count} "
              f"kernels (device idle {100 * (1 - device / host):.1f} %); peak memory {peak:.2f} GiB; {card}",
              flush=True)


# ---------------------------------------------------------------------------
# Phase 15: the data CLIs (cli/harvest_real_crops.py, make_pipeline_crops.py,
# smoke.py's rendering route) and the leftovers
# ---------------------------------------------------------------------------

HARVEST_REFERENCE = os.path.join(ROOT, "tests", "data", "harvest_jax_f32.json")
PIPELINE_REFERENCE = os.path.join(ROOT, "tests", "data", "pipeline_jax_f32.json")
PIPELINE_PAGES = os.path.join(ROOT, "tests", "data", "pipeline_pages.npz")
CONF_TOLERANCE = 1e-3  # labels.json's conf, rounded to 3 decimals


# One float32 box of the harvest can differ from JAX's: in covers/book5.png
# the quantized region plane's pixel (25, 27) lies within 3e-6 of 102.5 / 255
# (0.40196148 in the port's CPU map, 0.40195879 in JAX's;
# ``HARVEST_WITNESS``), so the port downloads 103 where JAX has 102, on the
# other side of low_text (0.4) for the multi-line split. The port then lacks
# JAX's box 1 of that photo ("199", not kept), and the photo's later crops
# are numbered one lower. Which side the card's map takes decides which
# harvest it must give (``check_harvest``).
HARVEST_WITNESS = os.path.join(ROOT, "tests", "data", "harvest_witness_jax_f32.json")
HARVEST_SHIFT = ("covers_book5_book5", 1)  # (crop tag, JAX's index of the box the port lacks)


def shifted_names(names, tag: str, lost: int) -> dict:
    """JAX crop name -> the port's, when the port lacks JAX's box ``lost``
    of the photo ``tag`` (its later boxes are numbered one lower)."""
    out = {}
    for name in names:
        stem, k = name[: -len("_00.png")], int(name[-6:-4])
        out[name] = name if stem != tag or k < lost else None if k == lost else f"{stem}_{k - 1:02d}.png"
    return out


def card_witness_q(dev, witness_path: str) -> tuple:
    """(the card's quantized region value, the port CPU's, JAX's) at the
    witness pixel of ``witness_path``'s photo, read as the harvest reads it."""
    from bbocr_tpu_torch.io import imread_gray
    from bbocr_tpu_torch.runtime import bucketing

    with open(witness_path) as f:
        w = json.load(f)
    gray = engine_module._to_gray_u8(imread_gray(os.path.join(REAL_DIR, w["book"], w["image"])))
    h, wd = w["canvas"]
    _, oh, ow = bucketing.letterbox_params(gray.shape[0], gray.shape[1], bucketing.CanvasSpec(h, wd))
    batch = np.zeros((1, h, wd), np.float32)
    batch[0, :oh, :ow] = engine_module._host_resize(gray, oh, ow)
    engine = default_engine(dev, torch.float32)
    _, region_q = engine.detect(torch.from_numpy(batch).to(dev))
    p = w["quantized_pixels"][0]
    got = int(region_q[0, p["y"], p["x"]])
    print(f"  harvest witness ({w['book']}/{w['image']}, canvas {h}x{wd}): quantized region at ({p['y']}, "
          f"{p['x']}) {got} on the card, {p['port_q']} on the port's CPU ({p['port_region']!r}), {p['jax_q']} in "
          f"JAX ({p['jax_region']!r})", flush=True)
    return got, p["port_q"], p["jax_q"]


def harvest_problems(out_dir: str, labels: dict, ref_path: str, renames=None) -> list:
    """Differences of a harvest (``labels`` and the crops written into
    ``out_dir``) from the JAX package's recorded one: the same crop names,
    labels, decodes, ``align_cer`` and ``align_margin``, ``conf`` within
    1e-3, and the same crop shapes with pixels within 1 (the device warp's
    float32 sums land within 1e-3 of JAX's, and a truncation to uint8 can
    turn that into 1)."""
    from bbocr_tpu_torch.io import read_png

    with open(ref_path) as f:
        ref = json.load(f)
    with np.load(os.path.join(os.path.dirname(ref_path), ref["crops_file"])) as data:
        ref_crops = {k: data[k] for k in data.files}
    renames = renames or {}
    expected = {renames.get(name, name): name for name in ref["labels"] if renames.get(name, name) is not None}
    problems = []
    if sorted(labels) != sorted(expected):
        problems.append(f"crops {sorted(set(labels) ^ set(expected))} are in one harvest only")
    pixels = 0
    for name in sorted(set(labels) & set(expected)):
        got, want = labels[name], ref["labels"][expected[name]]
        for key in ("label", "decode", "align_cer", "align_margin"):
            if got[key] != want[key]:
                problems.append(f"{name}: {key} {got[key]!r}, JAX {want[key]!r}")
        if abs(got["conf"] - want["conf"]) > CONF_TOLERANCE + 1e-9:
            problems.append(f"{name}: conf {got['conf']}, JAX {want['conf']}")
        crop, ref_crop = read_png(os.path.join(out_dir, name)), ref_crops[expected[name]]
        if crop.shape != ref_crop.shape:
            problems.append(f"{name}: crop {crop.shape}, JAX {ref_crop.shape}")
            continue
        diff = np.abs(crop.astype(int) - ref_crop)
        pixels += int((diff > 0).sum())
        if diff.max() > 1:
            problems.append(f"{name}: crop pixels differ by up to {diff.max()}")
    print(f"  {len(labels)} crops against JAX's {len(ref['labels'])}; {pixels} crop pixels differ by 1", flush=True)
    return problems


def check_harvest(dev, card) -> None:
    """15a: ``harvest_real_crops``'s loop over ``data/real/`` with a float32
    engine (TF32 off), held to the JAX package's float32 CPU run; then
    ``harvest()`` once as shipped (its bfloat16 engine), counts printed."""
    import tempfile

    from bbocr_tpu_torch.cli import harvest_real_crops

    engine = OCREngine.from_checkpoint(os.path.join(CKPT, "craft.npz"), os.path.join(CKPT, "crnn.npz"),
                                       float32_config(), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        stats = harvest_real_crops.harvest_corpus(engine, tmp, data_dir=REAL_DIR)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with open(os.path.join(tmp, "labels.json")) as f:
            labels = json.load(f)
        print(f"15a float32: {json.dumps(stats)} in {seconds:.3f} s [{card}]", flush=True)
        got_q, port_q, jax_q = card_witness_q(dev, HARVEST_WITNESS)
        if got_q not in (port_q, jax_q):
            fail(f"harvest witness: the card's quantized region is {got_q}, neither the port's {port_q} nor JAX's {jax_q}")
        renames = None
        if got_q == port_q:
            with open(HARVEST_REFERENCE) as f:
                renames = shifted_names(json.load(f)["labels"], *HARVEST_SHIFT)
            print(f"  the card takes the port's side: JAX's box {HARVEST_SHIFT[1]} of {HARVEST_SHIFT[0]} is "
                  "expected missing and that photo's later crops renumbered", flush=True)
        problems = harvest_problems(tmp, labels, HARVEST_REFERENCE, renames)
    if problems:
        fail(f"the float32 harvest differs from the JAX package's: {problems[:10]}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        stats = harvest_real_crops.harvest(os.path.join(CKPT, "craft.npz"), os.path.join(CKPT, "crnn.npz"), tmp,
                                           data_dir=REAL_DIR, device=dev)
        torch.cuda.synchronize()
        print(f"15a harvest() as shipped (bfloat16): {json.dumps(stats)} in {time.perf_counter() - t0:.3f} s "
              f"[{card}]", flush=True)
    if stats["crops_kept"] < 1:
        fail("harvest() kept no crop")


def check_pipeline_harvest(dev, card) -> None:
    """15b: ``make_pipeline_crops``'s harvest (``harvest_image`` with its gate
    0.3 and ``margin_accept=(0.6, 0.25)``) of the four 704x512 pages the
    JAX ``PageGenerator(seed=0)`` drew, float32, held to the JAX run."""
    import tempfile

    from bbocr_tpu_torch.cli.harvest_real_crops import harvest_image

    engine = OCREngine.from_checkpoint(os.path.join(CKPT, "craft.npz"), os.path.join(CKPT, "crnn.npz"),
                                       float32_config(), device=dev)
    with np.load(PIPELINE_PAGES) as data:
        pages = {k: data[k] for k in data.files}
    labels, stats = {}, {"pages": 0, "crops_seen": 0, "crops_kept": 0}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for i in range(len(pages) // 2):
            stats["pages"] += 1
            harvest_image(engine, pages[f"page{i}"], json.loads(str(pages[f"phrases{i}"])), f"page{i:05d}", tmp,
                          labels, stats, max_cer=0.3, margin_accept=(0.6, 0.25))
        print(f"15b: {json.dumps(stats)} in {time.perf_counter() - t0:.3f} s [{card}]", flush=True)
        problems = harvest_problems(tmp, labels, PIPELINE_REFERENCE)
    if problems:
        fail(f"the pipeline harvest differs from the JAX package's: {problems[:10]}")


def check_leftovers(dev, card) -> None:
    """15c: one read under ``device_trace`` (a Chrome trace naming a CUDA
    kernel), ``cli/smoke.py`` without ``--books-dir`` (it renders with
    Pillow and the DejaVu fonts: ``ImportError`` naming Pillow where it is
    missing, ``FileNotFoundError`` naming a font file where that is, else a
    passing smoke run), and ``__version__``."""
    import importlib.util
    import tempfile

    import bbocr_tpu_torch
    from bbocr_tpu_torch.cli import make_examples, smoke
    from bbocr_tpu_torch.utils.profiling import device_trace

    engine = OCREngine.from_checkpoint(os.path.join(CKPT, "craft.npz"), os.path.join(CKPT, "crnn.npz"),
                                       float32_config(), device=dev)
    image = load_rgb(BOOK1)
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp):
            engine.readtext(image)
            torch.cuda.synchronize()
        traces = [f for f in os.listdir(tmp) if f.endswith(".json")]
        if len(traces) != 1:
            fail(f"device_trace wrote {traces}")
        with open(os.path.join(tmp, traces[0])) as f:
            events = json.load(f).get("traceEvents", [])
    kernel_names = {e.get("name") for e in events if e.get("cat") == "kernel"}
    print(f"15c: device_trace: {len(events)} events, {len(kernel_names)} CUDA kernels, e.g. "
          f"{sorted(kernel_names)[:3]}", flush=True)
    if not kernel_names:
        fail("the device trace names no CUDA kernel")
    pillow = importlib.util.find_spec("PIL") is not None
    fonts = [f for f in (make_examples._FONTS_BOLD, make_examples._FONTS_REG, make_examples._FONTS_SERIF)
             if not os.path.exists(f)]
    try:
        rc = smoke.main(["--device", str(dev)])
    except ImportError as e:
        if pillow or "Pillow" not in str(e):
            fail(f"smoke without --books-dir raised ImportError({e}) (Pillow importable: {pillow})")
        print(f"15c: smoke without --books-dir, no Pillow here: ImportError({e})", flush=True)
    except FileNotFoundError as e:
        if not pillow or not fonts or fonts[0] not in str(e):
            fail(f"smoke without --books-dir raised FileNotFoundError({e}) (missing fonts: {fonts})")
        print(f"15c: smoke without --books-dir, Pillow here but not its fonts: FileNotFoundError({e})", flush=True)
    else:
        if not pillow or fonts or rc != 0:
            fail(f"smoke without --books-dir returned {rc} (Pillow importable: {pillow}, missing fonts: {fonts})")
        print("15c: smoke without --books-dir rendered a book and passed", flush=True)
    if bbocr_tpu_torch.__version__ != "0.1.0":
        fail(f"__version__ is {bbocr_tpu_torch.__version__}")
    print(f"15c: bbocr_tpu_torch.__version__ = {bbocr_tpu_torch.__version__}", flush=True)


# ---------------------------------------------------------------------------
# Phase 16: multi-device (parallel/, the engine's and the trainer's mesh)
# ---------------------------------------------------------------------------

MESH_BOOKS = ("1", "2", "3")


def results_identical(a, b) -> bool:
    return [[(np.asarray(q).tolist(), t, c) for q, t, c in r] for r in a] == \
        [[(np.asarray(q).tolist(), t, c) for q, t, c in r] for r in b]


def check_mesh(dev, card) -> dict:
    """16: a 1x1 mesh of one NCCL rank (``single_device_mesh()``), held bit
    for bit in float32 to the unsharded path: the mesh engine's
    ``readtext_batch`` over the five covers, ``BookMetadataExtractor`` given
    the mesh engine over ``books/1`` to ``books/3`` (the kernels' launches
    counted over it), one joint step and one CRNN step on the recorded
    batches. Returns the launches."""
    import torch.distributed as dist

    from bbocr_tpu_torch.models import CRAFT, CRNN
    from bbocr_tpu_torch.parallel.mesh import single_device_mesh
    from bbocr_tpu_torch.train import TrainConfig, TrainState, make_joint_train_step, make_optimizer
    from bbocr_tpu_torch.train import trainer
    from bbocr_tpu_torch.train.optim import tree_leaves
    from bbocr_tpu_torch.utils.checkpoint import load_params

    t0 = time.perf_counter()
    mesh = single_device_mesh()
    print(f"16: torch.cuda.device_count() = {torch.cuda.device_count()}; mesh {mesh.shape} {mesh.mesh_dim_names} "
          f"on {mesh.device_type}, backend {dist.get_backend()}, set up in {time.perf_counter() - t0:.3f} s", flush=True)
    ckpt = [os.path.join(CKPT, "craft.npz"), os.path.join(CKPT, "crnn.npz")]
    sharded = OCREngine.from_checkpoint(*ckpt, float32_config(), device=dev, mesh=mesh)
    plain = OCREngine.from_checkpoint(*ckpt, float32_config(), device=dev)
    covers = [load_rgb(os.path.join(REAL_DIR, "covers", f"book{i}.png")) for i in (1, 2, 4, 5, 6)]
    t0 = time.perf_counter()
    got = sharded.readtext_batch(covers)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = plain.readtext_batch(covers)
    print(f"16: the five covers through the mesh engine: {sum(map(len, got))} boxes in {seconds:.3f} s [{card}]",
          flush=True)
    if not results_identical(got, want):
        fail("the mesh engine's readtext_batch differs from the unsharded engine's")

    books = [[os.path.join(BOOKS_DIR, b, f) for f in sorted(os.listdir(os.path.join(BOOKS_DIR, b)))
              if f.lower().endswith(".jpg")] for b in MESH_BOOKS]
    metas = {}
    for name, engine in (("plain", plain), ("mesh", sharded)):
        extractor = BookMetadataExtractor(llm_backend="heuristic", engine=engine, device=dev)
        kernels.reset_launches()
        metas[name] = []
        for images in books:
            meta = extractor.extract_metadata_from_images(images)
            meta.pop("_processing_info")
            metas[name].append(meta)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
    print(f"16: books/1-3 through the extractor with the mesh engine: titles "
          f"{[m.get('title') for m in metas['mesh']]}; kernel launches {launches}", flush=True)
    if metas["mesh"] != metas["plain"]:
        fail("the extractor's metadata with the mesh engine differs from the unsharded engine's")
    for k, count in launches.items():
        if count < 1:
            fail(f"kernel {k} was not launched on the mesh route")

    with np.load(TRAIN_BATCHES) as data:
        b = {k: torch.from_numpy(data[k]).to(dev) for k in data.files}
    craft, crnn = CRAFT().to(dev), CRNN(num_classes=97).to(dev)
    craft.dtype = crnn.dtype = torch.float32
    cp = trainer.to_params(craft, load_params(ckpt[0]), dev)
    rp = trainer.to_params(crnn, load_params(ckpt[1]), dev)
    tx = make_optimizer(TrainConfig())
    state = TrainState(torch.zeros((), dtype=torch.int32, device=dev), cp, rp, tx.init((cp, rp)))
    joint = {"pages": b["craft_pages"], "maps": b["craft_maps"], "crops": b["crnn_crops"][:8],
             "labels": b["crnn_labels"][:8], "label_lens": b["crnn_label_lens"][:8],
             "frame_lens": b["crnn_frame_lens"][:8]}
    crnn_batch = tuple(b[k] for k in ("crnn_crops", "crnn_labels", "crnn_label_lens", "crnn_frame_lens"))
    def leaves(tree):
        return [leaf for leaf in tree_leaves(tree) if torch.is_tensor(leaf)]

    def max_diff(a, b) -> float:
        return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
                   for x, y in zip(leaves(a), leaves(b)))

    # cuDNN's weight gradients and the CTC's scatter-adds sum with atomics
    # unless told not to: the steps run with deterministic algorithms, and
    # the unsharded step twice, to show the comparison is bit for bit
    with deterministic_algorithms():
        for name, run in (
            ("joint", lambda m: make_joint_train_step(craft, crnn, tx, mesh=m, state_example=state)(state, joint)),
            ("crnn", lambda m: trainer.make_crnn_train_step(crnn, tx, mesh=m)(rp, tx.init(rp), *crnn_batch)),
        ):
            t0 = time.perf_counter()
            got = run(mesh)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            want, again = run(None), run(None)
            print(f"16: {name} step under the mesh: {len(leaves(got))} leaves, largest difference from the unsharded "
                  f"step {max_diff(got, want)!r} (the unsharded step against itself {max_diff(again, want)!r}), "
                  f"{seconds:.3f} s [{card}]", flush=True)
            if max_diff(again, want) == 0 and max_diff(got, want) != 0:
                fail(f"the {name} step under the 1x1 mesh differs from the unsharded step")
            if max_diff(again, want) != 0:
                fail(f"the unsharded {name} step is not reproducible under deterministic algorithms")
    dist.destroy_process_group()
    return launches


@contextlib.contextmanager
def deterministic_algorithms():
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[:2]
        torch.use_deterministic_algorithms(flags[2], warn_only=flags[3])


def f32_read(rgb: np.ndarray, dev, ops, engine: OCREngine):
    pre = _preprocess(rgb, 1.5, dev, ops)
    image = pre.cpu().numpy()
    return image, engine.readtext(image)


MOONLIGHT = os.path.join(ROOT, "portbench", "configs", "moonlight_16b_a3b.json")


def moe_bound_ms(kind: str, tokens: int, k: int, touched: float, width: int, hidden: int) -> float:
    """Least device ms of one of the routed experts' kernels in bfloat16
    (``gate_up``, ``down``, or ``both``): its products over the pairs at
    the tensor cores' peak, or each input byte read once and each output
    byte written once at the memory's (``gate_up``: the tokens, the touched
    experts' gate and up rows, a row of h a pair; ``down``: h, the down
    rows, a row of y a pair; ``both``: the tokens, all three, y)."""
    pairs = tokens * k
    mats, ins, outs = {"gate_up": (2, tokens * hidden, pairs * width), "down": (1, pairs * width, pairs * hidden),
                       "both": (3, tokens * hidden, pairs * hidden)}[kind]
    flops = 2.0 * pairs * mats * width * hidden
    byts = 2.0 * (touched * mats * width * hidden + ins + outs)
    return max(flops / BF16_OPS_PER_S, byts / HBM_BYTES_PER_S) * 1e3


def check_moe(dev, card) -> dict:
    """Phase 17 (see the module's docstring); returns the kernel's row."""
    from bbocr_tpu_torch.kernels import moe_gemm
    from bbocr_tpu_torch.models import mla_moe

    t0 = time.perf_counter()
    kernel_build.build_moe()
    kernel_build.load_moe()
    print(f"moe build seconds: {time.perf_counter() - t0:.2f}", flush=True)
    for line in ptxas_report(kernel_build.build_logs.get(kernel_build.MOE_SOURCE, "")):
        print(f"  ptxas: {line}", flush=True)
    with open(MOONLIGHT) as f:
        d = json.load(f)
    e, width, hidden, k = (d[key] for key in ("n_routed_experts", "moe_intermediate_size", "hidden_size",
                                              "num_experts_per_tok"))
    g = torch.Generator(device=dev).manual_seed(17)
    gate, up = (torch.randn(e, width, hidden, generator=g, device=dev).mul_(0.02).to(torch.bfloat16) for _ in range(2))
    down = torch.randn(e, hidden, width, generator=g, device=dev).mul_(0.02).to(torch.bfloat16)
    bias = torch.randn(e, generator=g, device=dev).mul_(0.3)  # uneven experts, as a trained router's
    row = {"name": "routed_experts", "source": "bbocr_tpu_torch/csrc/moe_gemm.cu", "replaces": "none"}
    for name, tokens in (("decode", 128), ("prefill", mla_moe.FFN_CHUNK)):
        x = torch.randn(tokens, hidden, generator=g, device=dev).to(torch.bfloat16)
        idx = (torch.rand(tokens, e, generator=g, device=dev) + bias).topk(k).indices
        weight = torch.rand(tokens, k, generator=g, device=dev)
        moe_gemm.reset_launches()
        got = moe_gemm.routed_experts(x, idx, weight, gate, up, down)
        torch.cuda.synchronize()
        if moe_gemm.routed_experts.launches != 1:
            fail(f"routed_experts counted {moe_gemm.routed_experts.launches} launches for one call")
        want = moe_gemm.routed_experts_plain(x, idx, weight, gate, up, down)
        diff = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        equal = float((got == want).float().mean())
        print(f"17 {name}: {tokens} tokens, max diff {diff:.4g} of max {scale:.4g}, "
              f"{equal:.6f} of values bit-equal to the per-expert loop", flush=True)
        # the same roundings, the products summed in another order: a value
        # of h or y may round the other way, by one bfloat16 step
        if diff > 2 ** -7 * scale:
            fail(f"routed_experts at {tokens} tokens differs from the per-expert loop by {diff} (max {scale})")
        fn = lambda: moe_gemm.routed_experts(x, idx, weight, gate, up, down)  # noqa: E731
        touched = int(torch.unique(idx).numel())
        timing = {"ms": median_ms(fn),
                  "library_ms": median_ms(lambda: moe_gemm.routed_experts_plain(x, idx, weight, gate, up, down),
                                          reps=5)}
        for kind in ("gate_up", "down"):
            timing[f"{kind}_device_ms"] = profiled_device_ms(fn, f"bbocr_moe_{kind}_kernel")
            timing[f"{kind}_device_ms_l2_flushed"] = profiled_device_ms(fn, f"bbocr_moe_{kind}_kernel", flush=True)
            timing[f"{kind}_bound_ms"] = moe_bound_ms(kind, tokens, k, touched, width, hidden)
        timing["bound_ms"] = moe_bound_ms("both", tokens, k, touched, width, hidden)
        bound_by = "FLOPs" if 2.0 * tokens * k * 3 * width * hidden / BF16_OPS_PER_S * 1e3 >= timing["bound_ms"] \
            else "bytes"
        print(f"17 {name} times (ms; bound by {bound_by}, {touched} experts touched; ms and library_ms per "
              f"call with the sort and the weighted sum): "
              + ", ".join(f"{key} {'not measured' if v is None else f'{v:.4f}'}" for key, v in timing.items())
              + f"; {card}", flush=True)
        row[name] = dict(timing, max_abs_err=diff, bit_equal_share=equal, bound_by=bound_by)
        del x, idx, weight, got, want
    del gate, up, down
    torch.cuda.empty_cache()

    a = d["assumed"]
    cfg = mla_moe.MLAMoEConfig.from_dict(d, a["bos_token_id"], a["eos_token_id"])
    scales = mla_moe.InitScales(**{key: a["init"][key] for key in ("std", "out_std", "embed_std", "norm_std",
                                                                     "bias_std")})
    t0 = time.perf_counter()
    model = mla_moe.init_random(cfg, 21, dev, torch.bfloat16, scales)
    torch.cuda.synchronize()
    print(f"17 Moonlight's weights drawn in {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(21)
    lengths = rng.integers(64, 512, 8)
    ids = np.zeros((8, int(lengths.max())), np.int64)
    for i, n in enumerate(lengths):
        ids[i, :n] = np.concatenate([[a["bos_token_id"]], rng.integers(0, a["ordinary_ids"], n - 1)])
    ids_t, lengths_t = torch.from_numpy(ids).to(dev), torch.from_numpy(lengths).to(dev)
    new = 16
    moe_layers = sum(cfg.is_moe(i) for i in range(cfg.num_hidden_layers))
    chunks = -(-int(lengths.sum()) // mla_moe.FFN_CHUNK)
    moe_gemm.reset_launches()
    first = mla_moe.generate(model, ids_t, lengths_t, new)
    torch.cuda.synchronize()
    # the first call prefills twice (before and after the capture) and runs
    # the step twice (eagerly, then captured); replays call no wrapper
    want = moe_layers * (2 * chunks + 2)
    print(f"17 generate, first call: routed_experts launches {moe_gemm.routed_experts.launches} "
          f"(want {want}), plain {moe_gemm.routed_experts_plain.launches}", flush=True)
    if moe_gemm.routed_experts.launches != want or moe_gemm.routed_experts_plain.launches:
        fail("mla_moe.generate did not run the grouped GEMM on every expert layer")
    from torch.profiler import ProfilerActivity, profile

    moe_gemm.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = mla_moe.generate(model, ids_t, lengths_t, new)
        torch.cuda.synchronize()
    if not torch.equal(again, first):
        fail("a replayed generate differs from the first call")
    counts, device_ms = {}, {}
    for ev in prof.key_averages():
        if ev.key.startswith("bbocr_moe_"):
            counts[ev.key] = ev.count
            device_ms[ev.key] = ev.self_device_time_total / 1e3
    print(f"17 generate, second call: routed_experts launches {moe_gemm.routed_experts.launches} "
          f"(want {moe_layers * chunks}); traced kernels {json.dumps(counts)}", flush=True)
    decode = {key: n for key, n in counts.items() if key.endswith("_decode")}
    prefill_pairs = int(lengths.sum()) * k
    steps = new - 1
    want_decode = moe_layers * (steps + (chunks if prefill_pairs < 32 * e else 0))
    for kind in ("gate_up", "down"):
        got_decode = counts.get(f"bbocr_moe_{kind}_kernel_bf16_decode", 0)
        got_all = got_decode + counts.get(f"bbocr_moe_{kind}_kernel_bf16_prefill", 0)
        if got_all != moe_layers * (chunks + steps) or got_decode != want_decode:
            fail(f"the traced {kind} kernels ran {got_all} times ({got_decode} decode), want "
                 f"{moe_layers * (chunks + steps)} ({want_decode} decode)")
    touched = e * (1.0 - (1.0 - k / e) ** 8)
    step_bound = moe_layers * moe_bound_ms("both", 8, k, touched, width, hidden)
    step_ms = sum(ms for key, ms in device_ms.items() if key in decode) / steps
    prefill_bound = moe_layers * moe_bound_ms("both", int(lengths.sum()), k, e, width, hidden)
    prefill_ms = sum(ms for key, ms in device_ms.items() if key not in decode) or None
    print(f"17 generate's experts: a decode step of 8 rows {step_ms:.4f} device ms (bound {step_bound:.4f}, "
          f"experts touched as under even routing); the prefill of {int(lengths.sum())} tokens "
          f"{'not measured' if prefill_ms is None else f'{prefill_ms:.4f}'} device ms (bound {prefill_bound:.4f}); "
          f"{card}", flush=True)
    row["generate"] = {"counts": counts, "step_device_ms": step_ms, "step_bound_ms": step_bound,
                       "prefill_device_ms": prefill_ms, "prefill_bound_ms": prefill_bound}
    del model
    torch.cuda.empty_cache()
    return row


def moe_only() -> int:
    """``--moe``: phases 1 and 17."""
    dev = torch.device("cuda", 0)
    phase("phase 1: card")
    card = card_line()
    print(card, flush=True)
    phase("phase 17: the routed experts' grouped GEMM at Moonlight's widths, and one generate")
    print(json.dumps({"moe": check_moe(dev, card)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--warmup-probe"]:
        return warmup_probe(sys.argv[2])
    if sys.argv[1:2] == ["--moe"]:
        return moe_only()
    dev = torch.device("cuda", 0)
    watch_swallowed()
    phase("phase 1: card")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)

    phase("phase 2: build kernels (nvcc) and labeler (g++)")
    print(f"build seconds: {build_all():.2f}", flush=True)

    phase("phase 3: kernels against their plain versions")
    rgb = load_rgb(BOOK1)
    report = check_kernels(rgb, dev)

    phase("phase 4: book1.png -> metadata JSON on the card (bfloat16 engine)")
    meta, launches, seconds, extractor = run_slice(dev)
    validate_schema(meta)
    _, issues = validate_metadata(meta)
    info = meta["_processing_info"]
    print(f"slice seconds: {seconds:.3f}", flush=True)
    print(json.dumps({k: meta[k] for k in ("title", "authors", "isbn_10", "isbn_13")}), flush=True)
    print(f"ocr boxes: {info['ocr_boxes']}; validation issues: {issues}", flush=True)
    print(f"stage times: {json.dumps(info['engine_timings'])}", flush=True)
    print(f"launches: {json.dumps(launches)}", flush=True)
    if info["ocr_boxes"] < 1:
        fail("the slice found no OCR boxes on book1.png")
    for name, count in launches.items():
        if count < 1:
            fail(f"kernel {name} was not launched by the slice")
        report[name]["launches"] = count
    t0 = time.perf_counter()
    extractor.extract_metadata_from_images([BOOK1], ocr_image_indices=[0])
    torch.cuda.synchronize()
    print(f"slice seconds, second run: {time.perf_counter() - t0:.3f}", flush=True)
    profile_warm_photo(extractor)
    image = _preprocess(rgb, 1.5, dev, KERNEL_OPS).cpu().numpy()
    time_lstm(extractor.engine, image)
    time_groupnorm(extractor.engine, image)
    check_bf16_reading(extractor.engine.readtext(image))

    phase("phase 5: float32, cuDNN TF32 off: kernels against plain versions end to end")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = slice_engine(dev, torch.float32)
    img_k, res_k = f32_read(rgb, dev, KERNEL_OPS, engine)
    img_p, res_p = f32_read(rgb, dev, PLAIN_OPS, engine)
    texts_k = [t for _, t, _ in res_k]
    texts_p = [t for _, t, _ in res_p]
    print(f"f32 texts (kernels): {texts_k}", flush=True)
    if not np.array_equal(img_k, img_p):
        fail(f"preprocessed images differ on {int((img_k != img_p).sum())} pixels")
    if texts_k != texts_p:
        fail(f"box texts differ: kernels {texts_k} vs plain {texts_p}")
    if not texts_k:
        fail("the float32 read found no text")

    phase("phase 6: float32 reading against the JAX package's reference")
    with open(REFERENCE) as f:
        ref = json.load(f)
    if texts_k != ref["texts"]:
        fail(f"texts {texts_k} differ from the JAX reference {ref['texts']}")
    quad_err = max(float(np.abs(np.asarray(q) - np.asarray(rq)).max()) for (q, _, _), rq in zip(res_k, ref["quads"]))
    print(f"{len(texts_k)} boxes, texts equal to the JAX reference, quads within {quad_err:.4f} px", flush=True)
    if quad_err > 1.0:
        fail(f"quads differ from the JAX reference by {quad_err} px (limit 1)")

    phase("phase 7: a camera photo, JPEG -> rotation route -> JSON")
    check_jpeg_digests()
    check_camera(dev, engine, extractor.engine)

    phase("phase 8: the default route (host rectification, rotations or fast path, both re-reads)")
    for name, count in check_default_route(dev, card).items():
        report[name]["launches_default_route"] = count

    phase("phase 9a: the no-engine extractor (shared engine in BatchingOCR), float32")
    wrapper, batch_log, inputs, launches = check_shared_route(dev, card)
    for name, count in launches.items():
        report[name]["launches_shared_route"] = count
    phase("phase 9b: BatchingOCR under 6 threads")
    check_batcher(wrapper, batch_log, inputs, card)
    wrapper.close()
    phase("phase 9c: readtext_stream in batches of 8")
    check_stream(dev, card)
    phase("phase 9d: warmup, fresh processes")
    check_warmup(card)
    phase("phase 9e: auto-crop")
    for name, count in check_autocrop(dev, card).items():
        report[name]["launches_autocrop_route"] = count
    phase("phase 9f: engine options on book1.png")
    check_engine_options(dev, card)

    phase("phase 10a: evaluate_real over data/real/ (21 books)")
    check_evaluate_real(dev, card)
    phase("phase 10b: evaluate_books over books/ (25 books)")
    for name, count in check_evaluate_books(dev, card).items():
        report[name]["launches_evaluate_books"] = count
    phase("phase 10c: the lite and published detector layouts")
    check_layouts(dev, card)

    phase("phase 11a: the JPEG and PNG encoders against Pillow's output")
    check_encoders(dev, card)
    phase("phase 11b: the LLM route (ollama, openai, gemini) through canned replies, float32")
    for name, count in check_llm_route(dev, card).items():
        report[name]["launches_llm_route"] = count
    phase("phase 11c: the host CLIs")
    check_host_clis(card)
    phase("phase 12: the scanner service on the card: jobs, review, pricing, approval")
    for name, count in check_service(dev, card).items():
        report[name]["launches_service"] = count
    phase("phase 13a: the PageReader on the shipped checkpoint, float32, against the JAX package's readings")
    f32_seconds = check_vlm_float32(dev, card)
    phase("phase 13b/13d: bfloat16, the client's type: vlm_eval --real and the book covers")
    bf16_seconds = check_vlm_bfloat16(dev, card)
    phase("phase 13c: the tpu route (extractor, service job), float32")
    for name, count in check_tpu_route(dev, card).items():
        report[name]["launches_pagereader_route"] = count
    phase("phase 13e: PageReader times")
    time_vlm(dev, card, f32_seconds, bf16_seconds)
    phase("phase 14a: the step makers in float32 against the JAX package's recorded steps")
    kernels.reset_launches()
    check_train_float32(dev, card)
    phase("phase 14b: the step makers in bfloat16")
    runs = check_train_bfloat16(dev, card)
    launches = {name: fn.launches for name, fn in kernels.KERNELS.items()}
    print(f"14a/14b: kernel launches while training {launches} (the training path runs no preprocessing)", flush=True)
    for name, count in launches.items():
        report[name]["launches_training"] = count
    phase("phase 14d: training times")
    time_train(runs, card)
    del runs
    phase("phase 14c: the training CLI's loop on the card: save, resume, serve the checkpoint")
    check_train_cli(dev, card)
    phase("phase 15a: harvest_real_crops over data/real/ (float32 against JAX, then as shipped)")
    check_harvest(dev, card)
    phase("phase 15b: make_pipeline_crops's harvest of four recorded pages")
    check_pipeline_harvest(dev, card)
    phase("phase 15c: device_trace, smoke's rendering route, __version__")
    check_leftovers(dev, card)
    phase("phase 16: a 1x1 mesh (NCCL): the engine, the extractor and two train steps against the unsharded path")
    for name, count in check_mesh(dev, card).items():
        report[name]["launches_mesh_route"] = count
    phase("phase 17: the routed experts' grouped GEMM at Moonlight's widths, and one generate")
    moe_row = check_moe(dev, card)
    phase("end: the kernels' line and the result")

    print(card, flush=True)
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms", "device_ms_l2_flushed",
             "launches_default_route", "launches_shared_route", "launches_autocrop_route", "launches_evaluate_books",
             "launches_llm_route", "launches_service", "launches_pagereader_route", "launches_training",
             "launches_mesh_route"]
    rows = [{k: report[name][k] for k in order} for name in kernels.KERNELS]
    print(json.dumps({"kernels": rows, "moe": moe_row}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
