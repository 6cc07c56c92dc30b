"""Write the JAX package's reading of a cover photo as JSON.

    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py \
        [--dtype float32|bfloat16] [--image data/real/covers/book1.png] [--out PATH]

The photo goes through ``_chain_gray_pallas`` and then ``OCREngine.readtext``
in the given compute type with the configuration the PyTorch port runs (no
host rectification, 8-bit wire, greedy decode, no pooled or coarse detect).
The default output is ``tests/data/book1_jax_f32.json`` or
``tests/data/book1_jax_bf16.json``. ``chip_smoke.py`` holds the port's
float32 reading on the card against the first (the same texts, quads within
1 px) and its default bfloat16 reading against the second.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image", default=os.path.join(ROOT, "data", "real", "covers", "book1.png"))
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    suffix = {"float32": "f32", "bfloat16": "bf16"}[args.dtype]
    out_path = args.out or os.path.join(ROOT, "tests", "data", f"book1_jax_{suffix}.json")

    import jax.numpy as jnp
    import numpy as np
    from PIL import Image

    from bbocr_tpu.ops import rgb_to_grayscale
    from bbocr_tpu.preprocess.chain import _chain_gray_pallas
    from bbocr_tpu.runtime.engine import EngineConfig, OCREngine

    rgb = np.asarray(Image.open(args.image).convert("RGB"))
    h, w = rgb.shape[:2]
    gray = rgb_to_grayscale(jnp.asarray(rgb, jnp.float32))
    pre = np.asarray(_chain_gray_pallas(gray, int(h * 1.5), int(w * 1.5)))
    config = EngineConfig(
        compute_dtype=getattr(jnp, args.dtype), host_rectify=False, wire_bits=8,
        decoder="greedy", detect_pool=1, detect_coarse=0,
    )
    engine = OCREngine.from_checkpoint(
        os.path.join(ROOT, "checkpoints", "craft.npz"),
        os.path.join(ROOT, "checkpoints", "crnn.npz"), config,
    )
    results = engine.readtext(pre)
    out = {
        "image": os.path.relpath(args.image, ROOT),
        "dtype": args.dtype,
        "texts": [t for _, t, _ in results],
        "quads": [np.asarray(q).round(3).tolist() for q, _, _ in results],
        "confidences": [round(float(c), 6) for _, _, c in results],
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"{len(results)} boxes -> {out_path}")


if __name__ == "__main__":
    main()
