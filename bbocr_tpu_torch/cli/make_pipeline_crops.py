"""Pipeline-consistent training crops: synthetic pages through the engine.

Counterpart of ``bbocr_tpu/cli/make_pipeline_crops.py``. The recognizer
trains on generator-rendered crops but serves on crops that went through
letterbox -> CRAFT -> CC quads -> rectification. This tool renders
synthetic pages at serving-like sizes (``train/synth.PageGenerator``: the
line texts are known), runs the serving engine over them, and keeps
rectified crops whose decode fuzzy-aligns to a drawn line
(``cli/harvest_real_crops.harvest_image``). Its output feeds
``cli/train --component crnn --pipeline-crops DIR[:frac]``.

The pages are drawn with Pillow (``train/synth.py``): where it is missing
the run raises ``ImportError`` naming it.

    python -m bbocr_tpu_torch.cli.make_pipeline_crops --pages 400 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--craft", default="checkpoints/craft.npz")
    p.add_argument("--crnn", default="checkpoints/crnn.npz")
    p.add_argument("--out", default="/tmp/pipeline_crops")
    p.add_argument("--pages", type=int, default=400)
    p.add_argument("--page-h", type=int, default=704)
    p.add_argument("--page-w", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-cer", type=float, default=0.3,
                   help="alignment gate; tighter than the real harvest "
                        "because synthetic decodes should be close")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from bbocr_tpu_torch.cli.harvest_real_crops import harvest_image
    from bbocr_tpu_torch.runtime.engine import OCREngine
    from bbocr_tpu_torch.train.synth import PageGenerator, SynthConfig

    engine = OCREngine.from_checkpoint(args.craft, args.crnn, device=args.device)
    gen = PageGenerator(SynthConfig(), seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    labels: dict = {}
    stats = {"pages": 0, "crops_seen": 0, "crops_kept": 0}
    for i in range(args.pages):
        page, _ = gen.render(args.page_h, args.page_w)
        phrases = [t for t in getattr(gen, "last_texts", []) if t.strip()]
        # last_texts lives on the generator that drew the lines
        if not phrases:
            phrases = [t for t in getattr(gen.lines, "last_texts", []) if t.strip()]
        if not phrases:
            continue
        stats["pages"] += 1
        harvest_image(
            engine, page.astype(np.uint8), phrases, f"page{i:05d}",
            args.out, labels, stats, max_cer=args.max_cer,
            # Per-page phrase lists are small, so a unique weak match still
            # identifies its line: keep hard crops (decode CER up to 0.6)
            # when the runner-up phrase is >=0.25 worse.
            margin_accept=(0.6, 0.25),
        )
        if (i + 1) % 50 == 0:
            print(f"{i + 1}/{args.pages} pages, kept {stats['crops_kept']}", flush=True)
    with open(os.path.join(args.out, "labels.json"), "w") as f:
        json.dump(labels, f, indent=1, ensure_ascii=False)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
