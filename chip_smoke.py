#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``bbocr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
``g++``. It:

1. prints the card's name and power limit;
2. builds the CUDA kernels (nvcc), the C++ labeler and the C++ JPEG
   decoder (g++) in parallel from the sources in the checkout, and prints
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
   ``bench.py`` runs it): each batch equal to ``readtext_batch``, photos per
   second and stage times printed; (d) ``warmup``: its calls and seconds,
   and a photo's first call with and without it, each in a fresh process
   (``python3 chip_smoke.py --warmup-probe with|without``); (e) auto-crop:
   the rectangles of the six preprocessed photos and the ``crop_for_ocr=True``
   extractor's JSON and routes must equal the JAX package's
   (``tests/data/autocrop_jax_f32.json``), kernel launches counted over that
   route, ``text_mask``'s time at a cover's size; (f) ``book1.png`` read with
   ``wire_bits`` 4 and 2, ``detect_pool=2``, ``detect_coarse=2`` and
   ``fold_gray_stem=False``: texts equal to the JAX package's and quads
   within 1 px (``tests/data/engine_options_jax_f32.json``), the letterbox
   and detect stages' ms against the default.

Phases 4 to 7 run the engine of the first slices (device warps from the
canvas, greedy decode), as their references were recorded; phases 8 and 9
run the defaults.

Any failed check exits non-zero. The line before the last is one JSON
object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import copy
import hashlib
import json
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
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


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


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
    with ThreadPoolExecutor(max_workers=3) as pool:
        futures = [pool.submit(kernel_build.build), pool.submit(native_loader.build), pool.submit(native_jpeg.build)]
        for f in futures:
            f.result()
    kernel_build.load()
    native_loader.load()
    native_jpeg.load()
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


def check_stream(dev, card) -> None:
    """9(c): ``readtext_stream`` in batches of 8 on the default (bfloat16)
    engine; each batch equal to ``readtext_batch``, whose first pass also
    warms every shape, as ``bench.py`` does; then a warm ``readtext_batch``
    pass over the same batches, timed for comparison."""
    engine = default_engine(dev)
    photos = stream_photos()
    batches = [photos[i:i + 8] for i in range(0, len(photos), 8)]
    t0 = time.perf_counter()
    want = [engine.readtext_batch(b) for b in batches]
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    engine.timers.reset()
    t0 = time.perf_counter()
    got = list(engine.readtext_stream(iter(batches)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stages = engine.timings()
    for i, (g, w) in enumerate(zip(got, want)):
        if len(g) != len(w) or not all(results_equal(a, b) for a, b in zip(g, w)):
            fail(f"readtext_stream batch {i} differs from readtext_batch")
    if len(got) != len(batches):
        fail(f"readtext_stream yielded {len(got)} batches for {len(batches)}")
    t0 = time.perf_counter()
    for b in batches:
        engine.readtext_batch(b)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    boxes = sum(len(r) for b in got for r in b)
    print(f"readtext_stream, bfloat16: {len(photos)} photos in {len(batches)} batches of 8, every batch equal to "
          f"readtext_batch; {seconds:.3f} s, {len(photos) / seconds:.3f} photos per second, {boxes} boxes; "
          f"readtext_batch over the same batches, first pass {first:.3f} s, warm pass after the stream {warm:.3f} s "
          f"({len(photos) / warm:.3f} photos per second); {card}", flush=True)
    print(f"readtext_stream stage times (host wall, summed over the stage threads): {json.dumps(stages)}; {card}",
          flush=True)


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


def f32_read(rgb: np.ndarray, dev, ops, engine: OCREngine):
    pre = _preprocess(rgb, 1.5, dev, ops)
    image = pre.cpu().numpy()
    return image, engine.readtext(image)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--warmup-probe"]:
        return warmup_probe(sys.argv[2])
    dev = torch.device("cuda", 0)
    log("phase 1: card")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)

    log("phase 2: build kernels (nvcc) and labeler (g++)")
    print(f"build seconds: {build_all():.2f}", flush=True)

    log("phase 3: kernels against their plain versions")
    rgb = load_rgb(BOOK1)
    report = check_kernels(rgb, dev)

    log("phase 4: book1.png -> metadata JSON on the card (bfloat16 engine)")
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

    log("phase 5: float32, cuDNN TF32 off: kernels against plain versions end to end")
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

    log("phase 6: float32 reading against the JAX package's reference")
    with open(REFERENCE) as f:
        ref = json.load(f)
    if texts_k != ref["texts"]:
        fail(f"texts {texts_k} differ from the JAX reference {ref['texts']}")
    quad_err = max(float(np.abs(np.asarray(q) - np.asarray(rq)).max()) for (q, _, _), rq in zip(res_k, ref["quads"]))
    print(f"{len(texts_k)} boxes, texts equal to the JAX reference, quads within {quad_err:.4f} px", flush=True)
    if quad_err > 1.0:
        fail(f"quads differ from the JAX reference by {quad_err} px (limit 1)")

    log("phase 7: a camera photo, JPEG -> rotation route -> JSON")
    check_jpeg_digests()
    check_camera(dev, engine, extractor.engine)

    log("phase 8: the default route (host rectification, rotations or fast path, both re-reads)")
    for name, count in check_default_route(dev, card).items():
        report[name]["launches_default_route"] = count

    log("phase 9a: the no-engine extractor (shared engine in BatchingOCR), float32")
    wrapper, batch_log, inputs, launches = check_shared_route(dev, card)
    for name, count in launches.items():
        report[name]["launches_shared_route"] = count
    log("phase 9b: BatchingOCR under 6 threads")
    check_batcher(wrapper, batch_log, inputs, card)
    wrapper.close()
    log("phase 9c: readtext_stream in batches of 8")
    check_stream(dev, card)
    log("phase 9d: warmup, fresh processes")
    check_warmup(card)
    log("phase 9e: auto-crop")
    for name, count in check_autocrop(dev, card).items():
        report[name]["launches_autocrop_route"] = count
    log("phase 9f: engine options on book1.png")
    check_engine_options(dev, card)

    print(card, flush=True)
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms", "device_ms_l2_flushed",
             "launches_default_route", "launches_shared_route", "launches_autocrop_route"]
    rows = [{k: report[name][k] for k in order} for name in kernels.KERNELS]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
