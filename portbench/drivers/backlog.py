"""Traffic driver ``backlog``: a backlog of pages through the PageReader.

Reads a traffic file with:

- ``corpus``: globs of page photos; ``batch``: pages per
  ``models/vlm.py::greedy_generate`` call;
- ``rate_metric``: the end-to-end metric this cell reports, pages
  completed over the window's time;
- ``check_pages``: how many finished pages, drawn from the seed with the
  longest among them, the reference judges after the window.

Each page is made as the program's ``tpu`` route makes it
(``io.load_gray`` on the file's bytes, ``llm/native_vlm.py::letterbox_page``)
on a host thread, the next batch while the current one decodes. The
seed's permutation of the corpus is cycled; set-up runs the first batch
once, the window starts the sequence again, offers batches until
``--seconds`` have passed and ends when the last one it offered is read
back.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

from portbench.core import corpus, registry
from portbench.core.bench import Check, Run


def build_model(config: Dict, device, root: str = registry.ROOT):
    import torch

    from bbocr_tpu_torch.llm import native_vlm
    from bbocr_tpu_torch.models import vlm
    from bbocr_tpu_torch.utils.checkpoint import load_params

    model = vlm.PageReader(dtype=getattr(torch, config["dtype"]))
    model.load_params(load_params(f"{root}/{config['checkpoint']}")).to(device).eval()
    have = {
        "dim": model.dim, "enc_depth": len(model.encoder.blocks), "dec_depth": len(model.blocks),
        "heads": model.blocks[0].attns[0].heads, "patch": model.encoder.patch, "max_len": model.max_len,
        "vocab": model.vocab, "page_h": native_vlm.PAGE_H, "page_w": native_vlm.PAGE_W,
        "pad_id": vlm.PAD_ID, "bos_id": vlm.BOS_ID, "eos_id": vlm.EOS_ID,
    }
    differ = {k: (v, config[k]) for k, v in have.items() if config[k] != v}
    if differ:
        raise ValueError(f"the program's PageReader differs from the configuration (program, file): {differ}")
    return model


def setup(run: Run) -> None:
    st = run.state
    st["model"] = build_model(run.cell.config, run.device)
    st["paths"] = corpus.paths(run.cell.traffic["corpus"])
    st["order"] = corpus.order(run.seed, len(st["paths"]))
    st["prep"] = ThreadPoolExecutor(max_workers=1)
    st["grays"] = {}
    _pump(run, limit=int(run.cell.traffic["batch"]))  # warm-up: the first batch


def _pump(run: Run, limit: int = None, stop_at: float = None) -> List:
    import torch

    from bbocr_tpu_torch.io import load_gray
    from bbocr_tpu_torch.llm.native_vlm import letterbox_page
    from bbocr_tpu_torch.models.vlm import greedy_generate

    st = run.state
    model, names, perm = st["model"], st["paths"], st["order"]
    batch = int(run.cell.traffic["batch"])
    n = len(names)

    def prepare(b: int):
        ids = list(range(b * batch, (b + 1) * batch))
        pages = []
        for i in ids:
            k = int(perm[i % n])
            with open(f"{registry.ROOT}/{names[k]}", "rb") as f:
                gray = load_gray(f.read())
            st["grays"].setdefault(k, gray)
            pages.append(letterbox_page(gray))
        return ids, torch.from_numpy(np.stack(pages))[..., None]

    done = []
    nxt = st["prep"].submit(prepare, 0)
    b = 0
    while True:
        ids, pages = nxt.result()
        nxt = st["prep"].submit(prepare, b + 1)
        tokens = greedy_generate(model, pages.to(run.device)).cpu().numpy()
        done.append((ids, tokens, time.perf_counter()))
        b += 1
        if (limit is not None and b * batch >= limit) or (stop_at is not None and time.perf_counter() >= stop_at):
            break
    nxt.result()  # the batch prepared ahead is not offered
    return done


def window(run: Run) -> None:
    st = run.state
    t0 = time.perf_counter()
    done = _pump(run, stop_at=t0 + run.seconds)
    run.window_s = done[-1][2] - t0
    run.attempted = run.completed = sum(len(ids) for ids, _, _ in done)
    run.end_to_end[run.cell.traffic["rate_metric"]] = run.completed / run.window_s
    n = len(st["paths"])
    st["answers"] = [(int(st["order"][i % n]), row) for ids, tokens, _ in done for i, row in zip(ids, tokens)]


def release(run: Run) -> None:
    run.state["prep"].shutdown(wait=True)
    run.state.pop("model", None)


def install_control(run: Run) -> None:
    """The control of a served model needs no decode of its own: the check
    reads, at the served positions, the gap of the token that the reference
    computed in float8 puts first."""
    from portbench.core import lowp

    run.state["control_q"] = lowp.fp8


def check(run: Run) -> List[Check]:
    """Digests of the decoded planes, then the reference's judgement of a
    sample of the finished pages (the control's reading after
    ``install_control``)."""
    from portbench.core import lowp

    st = run.state
    cfg = run.cell.config
    limits = run.cell.limits
    decoded = {st["paths"][k]: g for k, g in st["grays"].items()}
    checks = [Check("decode_sha256_mismatches", float(len(corpus.digest_mismatches(decoded, "pil_l"))),
                    float(limits["decode_sha256_mismatches"]))]
    lowp.precise_matmuls()
    mod = registry.reference(run.cell)
    ref = mod.PageReference(cfg, registry.ROOT, run.device)
    answers = st["answers"]
    lengths = np.array([mod.served_length(row, cfg["eos_id"]) for _, row in answers])
    k = min(int(run.cell.traffic["check_pages"]), len(answers))
    pick = set(corpus.rng(run.seed, 1).choice(len(answers), size=k, replace=False).tolist())
    pick.add(int(lengths.argmax()))
    rows = sorted(pick)
    t0 = time.perf_counter()
    gap, judged = ref.gaps([st["grays"][answers[i][0]].astype(np.uint8) for i in rows],
                           np.stack([answers[i][1] for i in rows]), st.get("control_q"))
    run.counters["check_s"] = time.perf_counter() - t0
    run.counters["checked_pages"] = len(rows)
    run.counters["checked_tokens"] = judged
    checks.append(Check("token_gap", gap, float(limits["token_gap"])))
    return checks
