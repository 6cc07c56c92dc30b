#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``bbocr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
``g++``. It:

1. prints the card's name and power limit;
2. builds the CUDA kernels (nvcc) and the C++ labeler (g++) in parallel
   from the sources in the checkout, and prints the build seconds;
3. holds each kernel bit-exact against its plain PyTorch version on the
   card at 70x90 (N=2), 33x41 and at the slice's (1, 1312, 1050), and times
   both there: ``ms`` and ``plain_ms`` are the median of 20 single calls
   between CUDA events (launch included), ``device_ms`` the kernel's own
   device time from torch.profiler;
4. turns ``data/real/covers/book1.png`` into metadata JSON through the
   port's extractor on the card (default bfloat16 engine), with every
   kernel launch count set to 0 just before and read just after: each
   kernel must have run;
5. reads the same photo in float32 (cuDNN TF32 off) with the kernels and
   with their plain versions: the preprocessed images and the box texts
   must be identical;
6. holds that float32 reading against the JAX package's, recorded in
   ``tests/data/book1_jax_f32.json``: the same texts, quads within 1 px.

Any failed check exits non-zero. The line before the last is one JSON
object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bbocr_tpu_torch import kernels
from bbocr_tpu_torch.extract import validate_metadata, validate_schema
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.kernels import build as kernel_build
from bbocr_tpu_torch.native import loader as native_loader
from bbocr_tpu_torch.ops import rounded_mean
from bbocr_tpu_torch.preprocess.chain import KERNEL_OPS, PLAIN_OPS, _preprocess
from bbocr_tpu_torch.runtime import EngineConfig, OCREngine

ROOT = os.path.dirname(os.path.abspath(__file__))
BOOK1 = os.path.join(ROOT, "data", "real", "covers", "book1.png")
CKPT = os.path.join(ROOT, "checkpoints")
# The JAX package's float32 reading of book1.png (scripts/torch_port_reference.py)
REFERENCE = os.path.join(ROOT, "tests", "data", "book1_jax_f32.json")
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


def build_all() -> float:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(kernel_build.build), pool.submit(native_loader.build)]
        for f in futures:
            f.result()
    kernel_build.load()
    native_loader.load()
    seconds = time.perf_counter() - t0
    for line in kernel_build.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
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


def profiled_device_ms(fn, symbol: str, reps: int = TIMING_REPS):
    """Device time per call of the kernels whose name holds ``symbol``, from
    torch.profiler's CUDA trace; None when the trace has no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
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


def check_kernels(rgb: np.ndarray, dev) -> dict:
    """Bit-exactness at three shapes; timings at the slice's shape."""
    cases = [
        ("2x70x90", random_inputs(2, 70, 90, 0, dev)),
        ("1x33x41", random_inputs(1, 33, 41, 1, dev)),
        ("1x1312x1050", chain_inputs(rgb, dev)),
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
        args = cases[-1][1][name]
        n, h, w = args[0].shape
        bytes_moved = 2 * n * h * w * 4 + (n * 4 if name == "enhance_u8" else 0)
        ops = n * h * w * KERNEL_INFO[name][1]
        byte_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        op_ms = ops / F32_OPS_PER_S * 1e3
        report[name] = {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": KERNEL_INFO[name][0],
            "max_abs_err": worst,
            "ms": median_ms(lambda: call(name, args, plain=False)),
            "plain_ms": median_ms(lambda: call(name, args, plain=True)),
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": None,
            "device_ms": profiled_device_ms(lambda: call(name, args, plain=False), KERNEL_INFO[name][2]),
        }
        r = report[name]
        device = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.5f} ms"
        log(f"{name}: bit-exact at {[c[0] for c in cases]}; at {n}x{h}x{w}: "
            f"{r['ms']:.5f} ms per call (plain {r['plain_ms']:.5f} ms), "
            f"kernel device time {device}, bound {r['bound_ms']:.5f} ms")
    return report


def run_slice(dev):
    from bbocr_tpu_torch.cli.process_book import make_extractor

    extractor = make_extractor(device=dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    meta = extractor.extract_metadata_from_images([BOOK1], ocr_image_indices=[0])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.KERNELS.items()}
    return meta, launches, seconds, extractor


def f32_read(rgb: np.ndarray, dev, ops, engine: OCREngine):
    pre = _preprocess(rgb, 1.5, dev, ops)
    image = pre.cpu().numpy()
    return image, engine.readtext(image)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
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

    log("phase 5: float32, cuDNN TF32 off: kernels against plain versions end to end")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = OCREngine.from_checkpoint(
        os.path.join(CKPT, "craft.npz"), os.path.join(CKPT, "crnn.npz"),
        EngineConfig(compute_dtype=torch.float32), device=dev,
    )
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

    print(card, flush=True)
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms"]
    rows = [{k: report[name][k] for k in order} for name in kernels.KERNELS]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
