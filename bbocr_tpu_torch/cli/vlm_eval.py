"""PageReader quality gate.

Counterpart of ``bbocr_tpu/cli/vlm_eval.py``:

1. ``--real``: field accuracy (exact + fuzzy) on ``data/real/``, the
   reference's own photos, each book's first image loaded as the client
   loads a page (``llm/native_vlm.py``: Pillow's ``convert("L")``, an
   aspect-keeping BILINEAR resize, a white letterbox) and scored with the
   fuzzy methodology of ``cli/evaluate``;
2. ``--synthetic``: exact-JSON rate and per-field accuracy on held-out
   synthetic title pages of the port's generator (``train/synth.py``),
   which draws with Pillow: it runs where Pillow is installed, and raises
   ``ImportError`` naming Pillow where it is not (the card's machine).

The JAX CLI runs both when neither flag is given; this one then runs
``--real`` only, which needs no Pillow. The model computes in bfloat16, the
client's type, on ``--device`` (default ``cuda``).

    python -m bbocr_tpu_torch.cli.vlm_eval --real [--ckpt checkpoints/vlm.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List

import numpy as np
import torch

from bbocr_tpu_torch.cli.evaluate import _norm, fuzzy_ratio


def _load(ckpt: str, device="cuda", dtype: torch.dtype = torch.bfloat16):
    from bbocr_tpu_torch.models.vlm import PageReader
    from bbocr_tpu_torch.utils.checkpoint import load_params

    return PageReader(dtype=dtype).load_params(load_params(ckpt)).to(device).eval()


def _generate(model, pages: np.ndarray) -> List[str]:
    from bbocr_tpu_torch.models.vlm import decode_ids, greedy_generate

    device = model.head.weight.device
    ids = greedy_generate(model, torch.as_tensor(pages, dtype=torch.float32, device=device)[..., None]).cpu()
    return [decode_ids(ids[i]) for i in range(ids.shape[0])]


def _parse(s: str) -> Dict[str, Any]:
    try:
        from bbocr_tpu_torch.extract import repair_and_parse

        return repair_and_parse(s) or {}
    except Exception:
        return {}


def eval_synthetic(model, n: int, batch: int, h: int, w: int) -> Dict[str, Any]:
    """Exact-JSON rate, valid-JSON rate and field accuracy on ``n`` held-out
    synthetic title pages (``train/synth.py``, seed 777_777, drawn with
    Pillow)."""
    from bbocr_tpu_torch.train.synth import PageGenerator, SynthConfig

    gen = PageGenerator(SynthConfig(), seed=777_777)  # held out from training
    exact = valid = 0
    field_hits = field_total = 0
    for start in range(0, n, batch):
        b = min(batch, n - start)
        pages = np.zeros((b, h, w), np.float32)
        refs: List[str] = []
        for i in range(b):
            pages[i], js, _ = gen.render_labeled(h, w)
            refs.append(js)
        hyps = _generate(model, pages)
        for ref, hyp in zip(refs, hyps):
            exact += hyp == ref
            fr, fh = _parse(ref), _parse(hyp)
            valid += bool(fh)
            for k, v in fr.items():
                field_total += 1
                field_hits += fh.get(k) == v
    return {
        "n": n,
        "exact_json": round(exact / n, 3),
        "valid_json": round(valid / n, 3),
        "field_acc": round(field_hits / max(field_total, 1), 3),
    }


def eval_real(model, real_dir: str) -> Dict[str, Any]:
    from bbocr_tpu_torch.io import load_gray
    from bbocr_tpu_torch.llm.native_vlm import letterbox_page

    with open(os.path.join(real_dir, "ground_truth.json")) as f:
        books = json.load(f)["books"]
    rows = []
    exact = fuzzy = total = 0
    for key, truth in sorted(books.items()):
        if key.startswith("covers/"):
            paths = [os.path.join(real_dir, key + ".png")]
        else:
            paths = sorted(
                os.path.join(real_dir, key, img) for img in truth.get("images", [])
            )
        if not paths or not os.path.isfile(paths[0]):
            continue
        page = letterbox_page(load_gray(paths[0]))
        hyp = _parse(_generate(model, page[None])[0])
        row = {"book": key}
        for fld in ("title", "publisher", "year"):
            want = truth.get(fld)
            got = hyp.get(fld)
            if want is None:
                continue
            total += 1
            e = _norm(str(got or "")) == _norm(str(want))
            fz = e or fuzzy_ratio(str(got or ""), str(want)) >= 0.8
            exact += e
            fuzzy += fz
            row[fld] = {"want": want, "got": got, "fuzzy": bool(fz)}
        aw = truth.get("authors") or []
        ag = hyp.get("authors") or []
        if aw:
            total += 1
            fz = any(
                fuzzy_ratio(str(g), str(w)) >= 0.8 for g in ag for w in aw
            )
            fuzzy += fz
            exact += [_norm(str(x)) for x in ag] == [_norm(str(x)) for x in aw]
            row["authors"] = {"want": aw, "got": ag, "fuzzy": bool(fz)}
        rows.append(row)
    return {
        "books": len(rows),
        "fields": total,
        "exact_acc": round(exact / max(total, 1), 3),
        "fuzzy_acc": round(fuzzy / max(total, 1), 3),
        "rows": rows,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=os.path.join("checkpoints", "vlm.npz"))
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--page-h", type=int, default=256)
    p.add_argument("--page-w", type=int, default=192)
    p.add_argument("--real-dir", default=os.path.join("data", "real"))
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--real", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="torch device of the PageReader")
    args = p.parse_args(argv)
    if not (args.synthetic or args.real):
        args.real = True

    model = _load(args.ckpt, args.device)
    report: Dict[str, Any] = {"ckpt": args.ckpt}
    if args.synthetic:
        report["synthetic"] = eval_synthetic(model, args.n, args.batch, args.page_h, args.page_w)
        print(json.dumps({"synthetic": report["synthetic"]}), flush=True)
    if args.real:
        report["real"] = eval_real(model, args.real_dir)
        print(
            json.dumps({"real": {k: v for k, v in report["real"].items() if k != "rows"}}),
            flush=True,
        )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
