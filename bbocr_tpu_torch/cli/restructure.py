"""Offline structurer A/B: re-run the heuristic structurer over the saved
line inputs of an eval artifact; no engine, no card.

Counterpart of ``bbocr_tpu/cli/restructure.py``; it reads the artifacts of
both packages' ``evaluate_real``.

``cli/evaluate_real`` stores each book's exact structurer input
(``lines``: (text, conf, rel_height, image_index) per visual line) in its
JSON artifact. This tool replays ``extract.heuristics.heuristic_extract_lines``
over those lines with the CURRENT code and scores field accuracy against
``data/real/ground_truth.json``, next to the accuracy stored in the
artifact — so a structurer change is measurable in seconds against real
OCR output instead of minutes/hours of engine re-runs.

Usage:
    python -m bbocr_tpu_torch.cli.restructure --eval data/real/eval_r2_final.json
    python -m bbocr_tpu_torch.cli.restructure --eval a.json --verbose   # per-book
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

from bbocr_tpu_torch.cli.evaluate import REAL_FIELDS as FIELDS
from bbocr_tpu_torch.cli.evaluate import score_real_fields
from bbocr_tpu_torch.extract.heuristics import heuristic_extract, heuristic_extract_lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eval", required=True, help="eval_real JSON artifact")
    ap.add_argument("--real-dir", default=os.path.join("data", "real"))
    ap.add_argument("--verbose", action="store_true", help="per-book detail")
    ap.add_argument("--out", default=None, help="write re-scored rows JSON")
    args = ap.parse_args(argv)

    with open(args.eval) as f:
        art = json.load(f)
    with open(os.path.join(args.real_dir, "ground_truth.json")) as f:
        gt = json.load(f)
    gt = gt.get("books", gt)

    rows = []
    stored_hits: Dict[str, list] = {f: [] for f in FIELDS}
    new_hits: Dict[str, list] = {f: [] for f in FIELDS}
    new_ratios: Dict[str, list] = {f: [] for f in FIELDS}
    for row in art.get("details", []):
        key = row["book"]
        truth = gt.get(key)
        if truth is None:
            continue
        lines = row.get("lines")
        if lines:
            pred = heuristic_extract_lines([tuple(l) for l in lines])
        else:
            pred = heuristic_extract(row.get("ocr_text", ""))
        fields = score_real_fields(pred, truth)
        stored = row.get("fields", {})
        for f in FIELDS:
            if f in fields:
                new_hits[f].append(fields[f]["fuzzy"])
                new_ratios[f].append(fields[f]["ratio"])
            if isinstance(stored, dict) and f in stored:
                stored_hits[f].append(bool(stored[f].get("fuzzy")))
        rows.append({"book": key, "fields": fields,
                     "had_lines": bool(lines)})
        if args.verbose:
            for f, v in fields.items():
                old = (stored.get(f, {}) or {}).get("pred") if isinstance(stored, dict) else None
                mark = "+" if v["fuzzy"] else " "
                print(f"{key:18s} {f:9s} {mark} new={v['pred']!r} old={old!r} truth={v['truth']!r}")

    # mean fuzzy ratio tracks sub-threshold progress (a pick moving from
    # junk 0.2 to near-title 0.68 is invisible in fuzzy accuracy)
    print(f"\n{'field':10s} {'stored':>8s} {'replayed':>9s} {'ratio':>6s}   (fuzzy acc, n; mean ratio)")
    for f in FIELDS:
        s, n = stored_hits[f], new_hits[f]
        if not (s or n):
            continue
        fmt = lambda xs: f"{sum(xs)/len(xs):.3f}/{len(xs)}" if xs else "-"
        r = new_ratios[f]
        rs = f"{sum(r)/len(r):.3f}" if r else "-"
        print(f"{f:10s} {fmt(s):>8s} {fmt(n):>9s} {rs:>6s}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"rows -> {args.out}")


if __name__ == "__main__":
    main()
