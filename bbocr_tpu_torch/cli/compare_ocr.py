"""OCR engine bake-off harness.

Counterpart of ``bbocr_tpu/cli/compare_ocr.py``: run each available engine
(``tpu``, the CRAFT + CRNN engine, and ``tesseract`` when ``pytesseract``
imports) over images with and without preprocessing, record wall time,
text yield and the heuristic metadata, and persist a comparison JSON per
image. Photos are read with ``io.load_rgb`` (no Pillow) and preprocessed
by the port's chain on ``--device``.

    python -m bbocr_tpu_torch.cli.compare_ocr books/1/IMG_0002.jpg --out results/ --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict

import numpy as np

from bbocr_tpu_torch.io import as_u8_image, load_rgb


def _engines():
    out = ["tpu"]
    try:
        import pytesseract  # noqa: F401

        out.append("tesseract")
    except ImportError:
        pass
    return out


def run_engine(engine: str, image: np.ndarray, device="cuda") -> Dict[str, Any]:
    t0 = time.time()
    try:
        if engine == "tpu":
            from bbocr_tpu_torch.extract.extractor import _shared_engine

            text = _shared_engine(device).read_joined(image)
        elif engine == "tesseract":
            import pytesseract
            from PIL import Image

            text = pytesseract.image_to_string(Image.fromarray(as_u8_image(image)))
        else:
            raise ValueError(engine)
        err = None
    except Exception as e:
        text, err = "", str(e)
    elapsed = time.time() - t0
    from bbocr_tpu_torch.extract import heuristic_extract

    return {
        "processing_time": round(elapsed, 3),
        "text_length": len(text),
        "text": text[:2000],
        "heuristic_metadata": {
            k: v for k, v in heuristic_extract(text).items() if v not in (None, [], {})
        },
        "error": err,
    }


def compare_image(path: str, preprocess: bool = True, device="cuda") -> Dict[str, Any]:
    rgb = load_rgb(path).astype(np.float32)
    variants: Dict[str, np.ndarray] = {"raw": rgb}
    if preprocess:
        from bbocr_tpu_torch.preprocess import preprocess_for_book_cover

        pre, _ = preprocess_for_book_cover(rgb, device=device)
        variants["preprocessed"] = pre.cpu().numpy()

    report: Dict[str, Any] = {"image": path}
    for variant, img in variants.items():
        for engine in _engines():
            report[f"{engine}_{variant}"] = run_engine(engine, img, device)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description="Compare OCR engines on images")
    p.add_argument("images", nargs="+")
    p.add_argument("--no-preprocess", action="store_true")
    p.add_argument("--out", default=None, help="directory for per-image JSON reports")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for path in args.images:
        report = compare_image(path, preprocess=not args.no_preprocess, device=args.device)
        summary = {
            k: {"time_s": v["processing_time"], "chars": v["text_length"]}
            for k, v in report.items()
            if isinstance(v, dict)
        }
        print(os.path.basename(path), json.dumps(summary))
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            name = os.path.splitext(os.path.basename(path))[0]
            with open(os.path.join(args.out, f"ocr_comparison_{name}.json"), "w") as f:
                json.dump(report, f, indent=2)


if __name__ == "__main__":
    main()
