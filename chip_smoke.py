#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``bbocr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
``g++``. It:

1. prints the card's name and power limit;
2. builds the CUDA kernels (nvcc) and the C++ labeler (g++) in parallel
   from the sources in the checkout, and prints the build seconds;
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
   port's extractor on the card (default bfloat16 engine), with every
   kernel launch count set to 0 just before and read just after: each
   kernel must have run; then profiles one warm photo with torch.profiler
   and prints the top device ops, the device's idle share over the call
   and the time inside the bfloat16 LSTM; times the photo's GroupNorm
   calls in three forms (bfloat16 parameters, float32 input and
   parameters, bfloat16 input with float32 parameters); and holds the
   bfloat16 reading against the JAX package's, recorded in
   ``tests/data/book1_jax_bf16.json``: the same box count, each box's
   text and quad distance printed;
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
import re
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
# The JAX package's float32 and bfloat16 readings of book1.png on the CPU
# (scripts/torch_port_reference.py)
REFERENCE = os.path.join(ROOT, "tests", "data", "book1_jax_f32.json")
REFERENCE_BF16 = os.path.join(ROOT, "tests", "data", "book1_jax_bf16.json")
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
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(kernel_build.build), pool.submit(native_loader.build)]
        for f in futures:
            f.result()
    kernel_build.load()
    native_loader.load()
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


def profile_warm_photo(extractor) -> None:
    """torch.profiler over one warm bfloat16 photo: the top device ops, the
    device's idle share over the call, and the time inside the LSTM."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extractor.extract_metadata_from_images([BOOK1], ocr_image_indices=[0])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
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
    rows = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                  key=lambda e: e.self_device_time_total, reverse=True)
    print("top device ops (self device ms, calls, name):", flush=True)
    for e in rows[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms  {e.count:5d}  {e.key[:110]}", flush=True)
    for e in prof.key_averages():
        if e.key in ("aten::lstm", "aten::_cudnn_rnn", "aten::_cudnn_rnn_flatten_weight", "aten::linear", "aten::conv2d"):
            print(f"op {e.key}: {e.count} calls, {e.cpu_time_total / 1e3:.3f} ms host total, "
                  f"{e.device_time_total / 1e3:.3f} ms device total", flush=True)


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
    profile_warm_photo(extractor)
    image = _preprocess(rgb, 1.5, dev, KERNEL_OPS).cpu().numpy()
    time_groupnorm(extractor.engine, image)
    check_bf16_reading(extractor.engine.readtext(image))

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
             "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms", "device_ms_l2_flushed"]
    rows = [{k: report[name][k] for k in order} for name in kernels.KERNELS]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
