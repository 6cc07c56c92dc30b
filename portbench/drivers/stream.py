"""Traffic driver ``stream``: photos through ``OCREngine.readtext_stream``.

Reads a traffic file with:

- ``corpus``: globs of photos; ``batch``: photos per batch handed to the
  stream; ``depth``: the stream's batches in flight;
- ``decode_threads``: the host pool that decodes the next batch (the
  program's ``io.imread_gray``) while the current one is read;
- ``rate_metric``: the end-to-end metric this cell reports, photos
  completed over the window's time;
- ``check_photos``: how many finished requests, drawn from the seed, the
  reference judges after the window.

The seed's permutation of the corpus is cycled, each cycle cut into the
same batches (the last one of a cycle shorter where the batch does not
divide the corpus), so that every cycle is the same work. Set-up reads one
cycle; the window starts the sequence again, offers whole cycles until
``--seconds`` have passed and ends when the last batch it offered
completes; its time runs from the first batch's decode to that completion.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

from portbench.core import corpus, registry
from portbench.core.bench import Check, Run


def build_engine(config: Dict, device, root: str = registry.ROOT):
    """The configuration's engine, every option stated by the file."""
    import torch

    from bbocr_tpu_torch.decode.boxes import DetectionParams
    from bbocr_tpu_torch.runtime import bucketing
    from bbocr_tpu_torch.runtime.engine import EngineConfig, OCREngine

    eng = dict(config["engine"])
    detail = eng.pop("detail_scale")
    if bucketing.detail_scale() != detail:
        raise ValueError(f"the engine's detail scale is {bucketing.detail_scale()}, the configuration's {detail}")
    eng["canvases"] = tuple(bucketing.CanvasSpec(h, w) for h, w in eng["canvases"])
    eng["width_buckets"] = tuple(eng["width_buckets"])
    eng["batch_capacities"] = tuple(eng["batch_capacities"])
    eng["detection"] = DetectionParams(**eng["detection"])
    ec = EngineConfig(compute_dtype=getattr(torch, config["dtype"]), **eng)
    return OCREngine.from_checkpoint(f"{root}/{config['craft']}", f"{root}/{config['crnn']}", ec, device=device)


def setup(run: Run) -> None:
    tr = run.cell.traffic
    st = run.state
    st["engine"] = build_engine(run.cell.config, run.device)
    st["paths"] = corpus.paths(tr["corpus"])
    st["order"] = corpus.order(run.seed, len(st["paths"]))
    st["pool"] = ThreadPoolExecutor(max_workers=int(tr["decode_threads"]))
    st["grays"] = {}  # corpus index -> its decoded plane
    _pump(run, cycles=1)  # warm-up: one cycle, every batch shape of the window


def batches_of_cycle(n: int, batch: int) -> List[List[int]]:
    """Positions in the seed's order of each batch of one cycle."""
    return [list(range(i, min(i + batch, n))) for i in range(0, n, batch)]


def _pump(run: Run, cycles: int = None, stop_at: float = None) -> List:
    """Offer whole cycles of the seed's sequence to the stream, ``cycles`` of
    them or until ``stop_at`` at a cycle's end; returns [(request ids,
    answers, done time)]. Request ``i`` of cycle ``c`` has id ``c * n + i``."""
    from bbocr_tpu_torch.io import imread_gray

    st = run.state
    engine, pool, names, perm = st["engine"], st["pool"], st["paths"], st["order"]
    n = len(names)
    plan = batches_of_cycle(n, int(run.cell.traffic["batch"]))

    def decode(i: int) -> np.ndarray:
        k = int(perm[i % n])
        gray = imread_gray(f"{registry.ROOT}/{names[k]}")
        st["grays"].setdefault(k, gray)
        return gray

    def submit(b: int):
        c, j = divmod(b, len(plan))
        ids = [c * n + i for i in plan[j]]
        return ids, [pool.submit(decode, i) for i in ids]

    offered: List[List[int]] = []

    def feed():
        b = 0
        nxt = submit(0)
        try:
            while True:
                if b % len(plan) == 0 and b > 0:  # a cycle's end
                    if cycles is not None and b // len(plan) >= cycles:
                        break
                    if stop_at is not None and time.perf_counter() >= stop_at:
                        break
                ids, futs = nxt
                imgs = [f.result() for f in futs]
                nxt = submit(b + 1)  # the next batch decodes while this one is read
                offered.append(ids)
                yield imgs
                b += 1
        finally:
            for f in nxt[1]:
                f.cancel()
            for f in nxt[1]:
                if not f.cancelled():
                    f.exception()  # wait for it

    done = []
    for k, answers in enumerate(engine.readtext_stream(feed(), depth=int(run.cell.traffic["depth"]))):
        done.append((offered[k], answers, time.perf_counter()))
    st["offered"] = sum(len(ids) for ids in offered)
    return done


def window(run: Run) -> None:
    st = run.state
    engine = st["engine"]
    st["timings0"] = engine.timings()
    t0 = time.perf_counter()
    done = _pump(run, stop_at=t0 + run.seconds)
    run.window_s = done[-1][2] - t0
    st["timings1"] = engine.timings()
    st["done"] = done
    run.attempted = st["offered"]
    run.completed = sum(len(ids) for ids, _, _ in done)
    run.end_to_end[run.cell.traffic["rate_metric"]] = run.completed / run.window_s
    n = len(st["paths"])
    st["answers"] = [(int(st["order"][i % n]), ans) for ids, answers, _ in done for i, ans in zip(ids, answers)]


def release(run: Run) -> None:
    st = run.state
    st["pool"].shutdown(wait=True)
    st.pop("engine", None)
    st.pop("done", None)


def install_control(run: Run) -> None:
    """The reference in the program's place, in float8: the engine's
    detector and recognizer swapped for it before the window."""
    from portbench.core import lowp

    ref = registry.reference(run.cell)
    ref.install_control(run.state["engine"], ref.OCRReference(run.cell.config, registry.ROOT, run.device, lowp.fp8))


def check(run: Run) -> List[Check]:
    """Digests of the decoded planes, then the reference's judgement of a
    sample of the finished requests drawn from the seed. Every reading is
    kept in ``run.counters``; those the cell's limits name are compared."""
    from portbench.core import lowp

    st = run.state
    cfg = run.cell.config
    limits = run.cell.limits
    decoded = {st["paths"][k]: g for k, g in st["grays"].items()}
    checks = [Check("decode_sha256_mismatches", float(len(corpus.digest_mismatches(decoded, "cv2_gray"))),
                    float(limits["decode_sha256_mismatches"]))]
    lowp.precise_matmuls()
    ref = registry.reference(run.cell).OCRReference(cfg, registry.ROOT, run.device, lowp.exact)
    answers = st["answers"]
    k = min(int(run.cell.traffic["check_photos"]), len(answers))
    pick = corpus.rng(run.seed, 1).choice(len(answers), size=k, replace=False)
    total = {"peaks": 0, "missed": 0, "quads": 0, "extra": 0, "texts": 0, "texts_differ": 0}
    gaps: List[float] = []
    t0 = time.perf_counter()
    for i in sorted(pick):
        photo, ans = answers[i]
        got = ref.judge_photo(st["grays"][photo], ans)
        for name in total:
            total[name] += got[name]
        gaps += got["read_gaps"]
    run.counters.update(total, check_s=time.perf_counter() - t0, checked_photos=k)
    readings = {
        "det_missed_share": total["missed"] / max(total["peaks"], 1),
        "det_extra_share": total["extra"] / max(total["quads"], 1),
        "read_gap_mean": float(np.mean(gaps)) if gaps else 0.0,
        "read_gap_max": max(gaps, default=0.0),
        "read_text_differ_share": total["texts_differ"] / max(total["texts"], 1),
    }
    run.counters.update(readings)
    checks += [Check(name, value, limits[name]) for name, value in readings.items() if name in limits]
    return checks
