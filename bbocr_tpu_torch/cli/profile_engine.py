"""Per-stage engine profile on a device.

Counterpart of ``bbocr_tpu/cli/profile_engine.py``: separates what the
engine's StageTimer lumps together, in particular the "detect" stage into
upload, device compute and map download. Every timing syncs with a host
read-back of its result and then ``torch.cuda.synchronize()`` on a card.
Photos (``data/real/photos``, ``data/real/covers``, ``books``) are read in
gray without Pillow, as Pillow's ``convert("L")`` gives them.

Usage:
    python -m bbocr_tpu_torch.cli.profile_engine [--repeat 5] [--photos N] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sync(x) -> None:
    """A host read-back of ``x``, then a device-wide sync on a card."""
    if torch.is_tensor(x):
        x.cpu()
        if x.is_cuda:
            torch.cuda.synchronize(x.device)


def _load_photos(n: int):
    from bbocr_tpu_torch.io import load_gray

    paths = sorted(glob.glob(os.path.join(ROOT, "data", "real", "photos", "*", "*.jpg")))
    paths += sorted(glob.glob(os.path.join(ROOT, "data", "real", "covers", "*.png")))
    paths += sorted(glob.glob(os.path.join(ROOT, "books", "*", "*.jpg")))
    return [load_gray(p) for p in paths[:n]]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--photos", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from bbocr_tpu_torch.runtime import bucketing
    from bbocr_tpu_torch.runtime.engine import OCREngine, _host_resize
    from bbocr_tpu_torch.runtime.wire import pack_canvas, unpack_widen

    ckpt = os.path.join(ROOT, "checkpoints")
    engine = OCREngine.from_checkpoint(
        os.path.join(ckpt, "craft.npz"), os.path.join(ckpt, "crnn.npz"), device=args.device
    )
    photos = _load_photos(args.photos)
    print(f"backend={engine.device} photos={len(photos)}", flush=True)

    # warm every shape the run needs
    engine.warmup(photos)
    engine.readtext_batch(photos)

    # --- end-to-end + engine stage timers --------------------------------
    engine.timers.reset()
    t0 = time.perf_counter()
    for _ in range(args.repeat):
        engine.readtext_batch(photos)
    wall = (time.perf_counter() - t0) / args.repeat
    print(
        json.dumps(
            {
                "end_to_end_s_per_batch": round(wall, 3),
                "photos_per_sec": round(len(photos) / wall, 2),
                "stages": engine.timings(),
            }
        ),
        flush=True,
    )

    # --- detect micro-breakdown on the first photo's canvas --------------
    grays = photos
    canvas = bucketing.pick_canvas(grays[0].shape[0], grays[0].shape[1], engine.config.canvases)
    rows = args.chunk

    def letterbox():
        out = np.zeros((rows, canvas.height, canvas.width), np.uint8)
        for s, g in enumerate(grays[:rows]):
            _, oh, ow = bucketing.letterbox_params(g.shape[0], g.shape[1], canvas)
            out[s, :oh, :ow] = _host_resize(g, oh, ow)
        return out

    batch = letterbox()

    def timed(label, fn, sync=True):
        ts = []
        for _ in range(args.repeat):
            t = time.perf_counter()
            r = fn()
            if sync:
                _sync(r[0] if isinstance(r, tuple) else r)
            ts.append(time.perf_counter() - t)
        print(
            json.dumps(
                {
                    "op": label,
                    "canvas": f"{canvas.height}x{canvas.width}x{rows}",
                    "mean_ms": round(1e3 * float(np.mean(ts)), 1),
                    "min_ms": round(1e3 * float(np.min(ts)), 1),
                }
            ),
            flush=True,
        )
        return r

    # host letterbox cost (the engine's resize of the photo set)
    timed("host_letterbox", letterbox, sync=False)

    # upload alone (u8 canvas batch -> device, synced)
    bits = engine.config.wire_bits
    timed("upload_u8", lambda: torch.from_numpy(pack_canvas(batch, bits)).to(engine.device))

    dev_u8 = torch.from_numpy(pack_canvas(batch, bits)).to(engine.device)
    _sync(dev_u8)
    dev_f32 = unpack_widen(dev_u8, bits)
    _sync(dev_f32)

    # detect compute+download with input already on device
    timed("detect_resident", lambda: engine.detect(dev_f32, 1))

    # detect dispatch only (no map download): device compute through one
    # trailing sync after repeat dispatches
    t = time.perf_counter()
    for _ in range(args.repeat):
        m, r = engine.detect(dev_f32, 1)
    _sync(m)
    print(
        json.dumps(
            {
                "op": "detect_pipelined",
                "mean_ms": round(1e3 * (time.perf_counter() - t) / args.repeat, 1),
            }
        ),
        flush=True,
    )

    # map download alone
    m, r = engine.detect(dev_f32, 1)
    _sync(m)
    timed("maps_download", lambda: (m.cpu().numpy(), r.cpu().numpy()), sync=False)


if __name__ == "__main__":
    main()
