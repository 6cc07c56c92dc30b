"""Write the JAX package's readings, and Pillow's JPEG decodings, as
references for the PyTorch port.

    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py \
        [--dtype float32|bfloat16] [--image data/real/covers/book1.png] [--out PATH]
    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --rotations \
        [--dtype float32|bfloat16] [--image data/real/photos/3/IMG_9687.jpg] [--out PATH]
    python scripts/torch_port_reference.py --jpeg-digests [--out PATH]

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


def _engine(dtype: str):
    import jax.numpy as jnp

    from bbocr_tpu.runtime.engine import EngineConfig, OCREngine

    config = EngineConfig(
        compute_dtype=getattr(jnp, dtype), host_rectify=False, wire_bits=8,
        decoder="greedy", detect_pool=1, detect_coarse=0,
    )
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


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--rotations", action="store_true")
    mode.add_argument("--jpeg-digests", action="store_true")
    p.add_argument("--image", default=None)
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    data = os.path.join(ROOT, "tests", "data")
    suffix = {"float32": "f32", "bfloat16": "bf16"}[args.dtype]
    if args.jpeg_digests:
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
    print(f"{len(out.get('texts', out))} entries -> {out_path}")


if __name__ == "__main__":
    main()
