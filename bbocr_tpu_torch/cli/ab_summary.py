"""Compact comparison table over evaluate_real artifacts.

Counterpart of ``bbocr_tpu/cli/ab_summary.py``; it reads the artifacts of
both packages' ``evaluate_real``.

    python -m bbocr_tpu_torch.cli.ab_summary data/real/eval_r2*.json

Each artifact records the serving knobs it ran with (engine_config), so
the table is self-describing: one row per run with overall and covers
recall/CER plus the knob deltas.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def row(path: str) -> dict:
    with open(path) as f:
        d = json.load(f)
    cfg = d.get("engine_config", {})
    knobs = []
    if cfg.get("wire_bits", 8) != 8:
        knobs.append(f"wire{cfg['wire_bits']}")
    if cfg.get("host_rectify"):
        knobs.append("hostrect")
    if cfg.get("detect_coarse"):
        knobs.append(f"coarse{cfg['detect_coarse']}")
    if cfg.get("decoder", "greedy") != "greedy":
        knobs.append(cfg["decoder"])
    if cfg.get("detail_scale"):
        knobs.append(f"ds{cfg['detail_scale']}")
    return {
        "name": os.path.basename(path).replace("eval_", "").replace(".json", ""),
        "knobs": "+".join(knobs) or "default",
        "recall": d.get("tpu_mean_word_recall"),
        "cer": d.get("tpu_mean_phrase_cer"),
        "cov_recall": d.get("tpu_mean_word_recall_on_paired"),
        "cov_cer": d.get("tpu_mean_phrase_cer_on_paired"),
        "easy_recall": d.get("easyocr_mean_word_recall_on_paired"),
        "easy_cer": d.get("easyocr_mean_phrase_cer_on_paired"),
        "secs": d.get("total_seconds"),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("paths", nargs="+", help="eval json files or globs")
    args = p.parse_args(argv)
    paths = []
    for pat in args.paths:
        paths.extend(sorted(glob.glob(pat)) or [pat])
    rows = []
    for path in paths:
        try:
            rows.append(row(path))
        except (OSError, json.JSONDecodeError) as e:
            print(f"skip {path}: {e}")
    if not rows:
        return
    hdr = f"{'run':18s} {'knobs':24s} {'recall':>7s} {'cer':>6s} {'covers':>7s} {'covCER':>7s} {'secs':>6s}"
    print(hdr)
    print("-" * len(hdr))
    fmt = lambda v: "  -  " if v is None else f"{v:.3f}"  # noqa: E731
    for r in rows:
        print(
            f"{r['name']:18s} {r['knobs']:24s} {fmt(r['recall']):>7s} "
            f"{fmt(r['cer']):>6s} {fmt(r['cov_recall']):>7s} "
            f"{fmt(r['cov_cer']):>7s} {r['secs'] or 0:>6.0f}"
        )
    e = rows[0]
    if e.get("easy_recall") is not None:
        # a missing CER prints as "-" (the JAX table raises on it, as on
        # data/real/eval_r2_baseline.json)
        print(f"{'easyocr reference':18s} {'(recorded)':24s} {'-':>7s} {'-':>6s} "
              f"{fmt(e['easy_recall']):>7s} {fmt(e['easy_cer']):>7s}")


if __name__ == "__main__":
    main()
