"""Traffic driver ``lm_backlog``: a backlog of prompts through a decoder-only
language model's ``generate``.

Reads a traffic file with:

- ``batch``: requests per ``models/mla_moe.py::generate`` call;
- ``prefix_tokens``, ``prefix_seed``: a prefix shared by every request
  (the prompt template): the configuration's BOS, then ids drawn once from
  ``prefix_seed``, the same in every run;
- ``context_median``, ``context_sigma``, ``context_min``, ``context_max``:
  each request's own context (the OCR text), of lognormal length clipped
  to the range, its ids drawn from the run's seed, uniform over the
  configuration's ordinary ids (no specials);
- ``new_tokens``: greedy tokens a request is served;
- ``rate_metric``: the end-to-end metric this cell reports, requests
  completed over the window's time;
- ``check_requests``: how many finished requests, drawn from the seed with
  the one of the longest prompt among them, the reference judges after
  the window.

The weights are random, drawn from the run's seed by the configuration's
rule (drawn again in place where a window's seed is not set-up's, as
``control.py`` runs them). Batches are made on a host thread, the next
while the current one is served, and every call's cache has the slots of
the longest prompt the traffic can make plus ``new_tokens``, so that every
call replays one graph.
Set-up serves one batch (drawn apart from the window's); the window offers
batches until ``--seconds`` have passed and ends when the last one it
offered is read back.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from portbench.core import corpus, registry
from portbench.core.bench import Check, Run

WARMUP_STREAM = 2**20  # the set-up batch's stream of the seed; window batch b draws from stream b


def scales(config: Dict):
    from bbocr_tpu_torch.models import mla_moe

    init = config["assumed"]["init"]
    return mla_moe.InitScales(**{k: init[k] for k in ("std", "out_std", "embed_std", "norm_std", "bias_std")})


def build_model(config: Dict, seed: int, device):
    """The configuration's model with random weights from ``seed``; raises
    where the program's model differs from the file."""
    import torch

    from bbocr_tpu_torch.models import mla_moe

    a = config["assumed"]
    cfg = mla_moe.MLAMoEConfig.from_dict(config, a["bos_token_id"], a["eos_token_id"])
    # the constructor raises unless every tensor has ``param_shapes(cfg)``'s shape
    model = mla_moe.init_random(cfg, seed, device, getattr(torch, config["dtype"]), scales(config))
    have = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    have.update(mla_moe.MLAMoEConfig.FIXED, num_key_value_heads=cfg.num_attention_heads, ep_size=1,
                num_nextn_predict_layers=0)
    differ = {k: (v, config[k]) for k, v in have.items() if k in config and config[k] != v}
    if str(model.dtype).replace("torch.", "") != config["dtype"]:
        differ["dtype"] = (str(model.dtype), config["dtype"])
    if differ:
        raise ValueError(f"the program's model differs from the configuration (program, file): {differ}")
    return model


def slots(traffic: Dict) -> int:
    return int(traffic["prefix_tokens"]) + int(traffic["context_max"]) + int(traffic["new_tokens"])


def prefix(config: Dict, traffic: Dict) -> np.ndarray:
    rng = corpus.rng(int(traffic["prefix_seed"]))
    drawn = rng.integers(0, config["assumed"]["ordinary_ids"], int(traffic["prefix_tokens"]) - 1)
    return np.concatenate([[config["assumed"]["bos_token_id"]], drawn]).astype(np.int64)


def make_batch(config: Dict, traffic: Dict, head: np.ndarray, seed: int, stream: int) -> Tuple[np.ndarray, np.ndarray]:
    """(ids (batch, widest), lengths (batch,)): right-padded prompts."""
    rng = corpus.rng(seed, stream)
    n = int(traffic["batch"])
    ctx = np.clip(np.rint(rng.lognormal(np.log(traffic["context_median"]), traffic["context_sigma"], n)),
                  traffic["context_min"], traffic["context_max"]).astype(np.int64)
    lengths = len(head) + ctx
    ids = np.zeros((n, int(lengths.max())), np.int64)
    ids[:, : len(head)] = head
    for i, c in enumerate(ctx):
        ids[i, len(head) : len(head) + c] = rng.integers(0, config["assumed"]["ordinary_ids"], c)
    return ids, lengths


def setup(run: Run) -> None:
    st = run.state
    cfg, tr = run.cell.config, run.cell.traffic
    st["model"] = build_model(cfg, run.seed, run.device)
    st["weights_seed"] = run.seed
    if slots(tr) > cfg["max_position_embeddings"]:
        raise ValueError(f"{slots(tr)} positions exceed max_position_embeddings {cfg['max_position_embeddings']}")
    st["paths"] = []  # no corpus: ``control.py`` re-draws an order of it per seed; prompts follow ``run.seed``
    st["prefix"] = prefix(cfg, tr)
    st["prep"] = ThreadPoolExecutor(max_workers=1)
    _serve(run, [make_batch(cfg, tr, st["prefix"], run.seed, WARMUP_STREAM)])  # warm-up: the capture


def _serve(run: Run, batches=None, stop_at: float = None) -> List:
    """Serve ``batches``, or the seed's sequence until ``stop_at``; returns
    [(ids, lengths, tokens, done time)]."""
    import torch

    from bbocr_tpu_torch.models.mla_moe import generate

    st = run.state
    cfg, tr = run.cell.config, run.cell.traffic
    n_slots, new = slots(tr), int(tr["new_tokens"])

    def prepare(b: int):
        if batches is not None:
            return batches[b] if b < len(batches) else None
        return make_batch(cfg, tr, st["prefix"], run.seed, b)

    done = []
    nxt = st["prep"].submit(prepare, 0)
    b = 0
    while True:
        got = nxt.result()
        if got is None:
            break
        ids, lengths = got
        nxt = st["prep"].submit(prepare, b + 1)
        tokens = generate(st["model"], torch.from_numpy(ids).to(run.device), torch.from_numpy(lengths),
                          new, slots=n_slots).cpu().numpy()
        done.append((ids, lengths, tokens, time.perf_counter()))
        b += 1
        if stop_at is not None and time.perf_counter() >= stop_at:
            break
    nxt.result()  # the batch prepared ahead is not offered
    return done


def window(run: Run) -> None:
    st = run.state
    if st["weights_seed"] != run.seed:  # ``control.py``: one set-up, a seed a window
        from bbocr_tpu_torch.models.mla_moe import redraw

        redraw(st["model"], run.seed, scales(run.cell.config))
        st["weights_seed"] = run.seed
    t0 = time.perf_counter()
    done = _serve(run, stop_at=t0 + run.seconds)
    run.window_s = done[-1][3] - t0
    run.attempted = run.completed = sum(len(lengths) for _, lengths, _, _ in done)
    run.end_to_end[run.cell.traffic["rate_metric"]] = run.completed / run.window_s
    st["answers"] = [(ids[i, :n], row) for ids, lengths, tokens, _ in done for i, (n, row) in enumerate(zip(lengths, tokens))]


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
    """Every served id is a token of the vocabulary, then the reference's
    judgement of a sample of the finished requests (the control's reading
    after ``install_control``)."""
    from portbench.core import lowp

    st = run.state
    cfg = run.cell.config
    limits = run.cell.limits
    answers = st["answers"]
    bad = sum(int(((row < 0) | (row >= cfg["vocab_size"])).sum()) for _, row in answers)
    checks = [Check("out_of_vocab_ids", float(bad), float(limits["out_of_vocab_ids"]))]
    lowp.precise_matmuls()
    mod = registry.reference(run.cell)
    k = min(int(run.cell.traffic["check_requests"]), len(answers))
    pick = set(corpus.rng(run.seed, 1).choice(len(answers), size=k, replace=False).tolist())
    pick.add(max(range(len(answers)), key=lambda i: len(answers[i][0])))
    rows = sorted(pick)
    t0 = time.perf_counter()
    ref = mod.LMReference(cfg, run.seed, run.device)
    gap, mean, judged = ref.gaps([answers[i][0] for i in rows], [np.clip(answers[i][1], 0, cfg["vocab_size"] - 1)
                                                          for i in rows], st.get("control_q"))
    run.counters["check_s"] = time.perf_counter() - t0
    run.counters["checked_requests"] = len(rows)
    run.counters["checked_tokens"] = judged
    checks.append(Check("token_gap", gap, float(limits["token_gap"])))
    checks.append(Check("token_gap_mean", mean, float(limits["token_gap_mean"])))
    return checks
