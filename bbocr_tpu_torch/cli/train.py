"""Training CLI: synthetic-data training for the recognizer, the detector
and the PageReader, on the card.

    python -m bbocr_tpu_torch.cli.train --component crnn --steps 3000 --batch 128
    python -m bbocr_tpu_torch.cli.train --component craft --steps 1500 --batch 16
    python -m bbocr_tpu_torch.cli.train --component vlm --vlm-ctc-weight 0.5

Counterpart of ``bbocr_tpu/cli/train.py``, with its flags and defaults and
one more, ``--device`` (default ``cuda``). Host data generation runs in
forked worker processes feeding a bounded queue; the synthetic generators
(``train/synth.py``) draw with Pillow, so this CLI's data source needs
Pillow, which the card's machine lacks: there each loop takes another
source (``train_crnn(args, source=...)``, as ``chip_smoke.py`` passes
recorded batches). Checkpoints land in ``--out`` (default ./checkpoints) as
flat .npz in the JAX package's layout, which both packages' engines load;
``--state-dir`` keeps the full resumable state (``utils/train_ckpt.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import signal
import threading
import time
from typing import Any, Dict, List

import numpy as np
import torch

# Graceful stop: SIGTERM requests "save and exit at the next step boundary";
# a supervisor should `timeout --signal=TERM --kill-after=...` and let the loop
# finish its in-flight step, checkpoint and exit.
_STOP_REQUESTED = threading.Event()


def _install_sigterm_handler() -> None:
    owner_pid = os.getpid()

    def _handler(signum, frame):
        if os.getpid() != owner_pid:
            # forked data worker: terminate() means die NOW, not "finish
            # the step" — the inherited handler must not swallow it
            os._exit(0)
        _STOP_REQUESTED.set()
        print("SIGTERM: finishing current step, saving, exiting", flush=True)

    try:
        signal.signal(signal.SIGTERM, _handler)
    except ValueError:
        pass  # non-main thread (library use)


def _prefetch(make_batch, n_threads: int = 4, depth: int = 8):
    """Host-side batch prefetch into a bounded queue: ``(queue, stopper)``.

    Generation is pure-Python Pillow/numpy and GIL-bound, so the workers are
    forked PROCESSES (threads remain the fallback where fork is missing).
    The callers fork them before their first CUDA call: the children touch
    only numpy and Pillow, never torch's device, and a CUDA context does
    not survive a fork. The JAX CLI first warms its backend with one tiny
    compile (``_warm_backend``), because its relayed TPU backend deadlocked
    when a child was forked before the first compile; CUDA has no such
    order, so the port has no counterpart.
    """
    stop = threading.Event()
    try:
        import multiprocessing as mp

        ctx = mp.get_context("fork")
    except ValueError:
        ctx = None
    if ctx is not None:
        mq = ctx.Queue(maxsize=depth)

        def pworker(seed):
            rng = np.random.default_rng(seed)
            while True:
                mq.put(make_batch(int(rng.integers(0, 1 << 31))))

        procs = [ctx.Process(target=pworker, args=(i * 7919 + 13,), daemon=True) for i in range(n_threads)]
        for p in procs:
            p.start()

        class _Stop:
            def set(self):
                # Do NOT read mq here: a worker killed mid-put leaves a
                # truncated frame in the pipe, and a later get() blocks
                # forever. Kill the workers (bypassing their SIGTERM
                # handler) and never touch the queue again.
                for p in procs:
                    try:
                        p.kill()
                        p.join(timeout=5)
                    except Exception:
                        pass
                try:
                    mq.cancel_join_thread()
                except Exception:
                    pass

        return mq, _Stop()

    q: "queue.Queue" = queue.Queue(maxsize=depth)

    def worker(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            batch = make_batch(int(rng.integers(0, 1 << 31)))
            try:
                q.put(batch, timeout=1.0)
            except queue.Full:
                continue

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(n_threads)]
    for t in threads:
        t.start()
    return q, stop


class Batches:
    """A batch source that cycles through given batches: ``get()`` and the
    stopper's ``set()``, as ``_prefetch``'s pair offers them."""

    def __init__(self, batches: List[tuple]):
        self.batches, self.i = list(batches), 0

    def get(self):
        batch = self.batches[self.i % len(self.batches)]
        self.i += 1
        return batch

    def set(self):
        pass


def _source(args, make_batch, source):
    """(queue, stopper): the given source, or the synthetic prefetch, which
    needs Pillow: without it this raises ``ImportError`` naming Pillow
    before any worker is forked."""
    if source is not None:
        return source, source
    from bbocr_tpu_torch.train.photo_aug import require_pillow

    require_pillow("Image", "ImageDraw", "ImageFilter", "ImageFont")
    return _prefetch(make_batch, n_threads=args.data_threads)


def _train_config(args):
    from bbocr_tpu_torch.train import TrainConfig

    return TrainConfig(
        learning_rate=args.lr,
        schedule=args.schedule,
        warmup_steps=args.warmup,
        total_steps=args.steps,
    )


def _maybe_resume(args, params, opt_state):
    """Restore (params, opt_state, step) from --state-dir if a checkpoint
    exists there; otherwise pass through with step 0."""
    if not args.state_dir:
        return params, opt_state, 0
    from bbocr_tpu_torch.utils.train_ckpt import latest_checkpoint, restore_train_state

    path = latest_checkpoint(args.state_dir)
    if path is None:
        return params, opt_state, 0
    restored = restore_train_state(path, {"step": 0, "params": params, "opt_state": opt_state})
    start = int(restored["step"])
    print(f"resumed from {path} at step {start}", flush=True)
    return restored["params"], restored["opt_state"], start


def _maybe_save_state(args, step, params, opt_state):
    if not args.state_dir:
        return
    from bbocr_tpu_torch.utils.train_ckpt import save_train_state

    save_train_state(args.state_dir, {"step": step, "params": params, "opt_state": opt_state}, step=step)


def _gray_u8(path: str) -> np.ndarray:
    """``Image.open(path).convert("L")`` as uint8, without Pillow."""
    from bbocr_tpu_torch.io import load_gray

    return load_gray(path).astype(np.uint8)


def _to_height_32(img: np.ndarray) -> np.ndarray:
    """Pillow's ``resize((max(8, round(w * 32 / h)), 32), BILINEAR)`` of a
    crop whose height is not 32 (``ops.pil_resample_u8``)."""
    from bbocr_tpu_torch.ops import pil_resample_u8

    h, w = img.shape
    if h == 32:
        return img
    return pil_resample_u8(img, max(8, round(w * 32 / h)), 32)


def _load_real_val(dir_path: str, max_width: int):
    """Load harvested real crops (``cli/harvest_real_crops.py`` of the JAX
    package) into one padded (N_padded, 32, max_width) float32 array + N
    reference labels. Crops wider than max_width are aspect-squeezed like
    the engine's top bucket; rows are padded to a multiple of 64 (labels are
    NOT padded — callers decode only the first N rows). Pillow-free: the
    port's image reader and Pillow's BILINEAR in numpy."""
    from bbocr_tpu_torch.ops import pil_resample_u8

    with open(os.path.join(dir_path, "labels.json")) as f:
        meta = json.load(f)
    names = sorted(meta)
    refs, crops = [], []
    for name in names:
        img = _to_height_32(_gray_u8(os.path.join(dir_path, name)))
        if img.shape[1] > max_width:
            img = pil_resample_u8(img, max_width, 32)
        a = img.astype(np.float32)
        row = np.empty((32, max_width), np.float32)
        row[:, : a.shape[1]] = a
        row[:, a.shape[1] :] = a[:, -1:]
        crops.append(row)
        entry = meta[name]
        refs.append(entry["label"] if isinstance(entry, dict) else str(entry))
    n = len(crops)
    padded = ((n + 63) // 64) * 64
    out = np.zeros((padded, 32, max_width), np.float32)
    if n:
        out[:n] = np.stack(crops)
    return out, refs


def _load_pipeline_crops(dir_path: str):
    """Load pipeline-consistent crops (``cli/make_pipeline_crops.py`` of the
    JAX package) as [(u8 (32, w) array, label str)], Pillow-free. Loaded in
    the parent BEFORE the prefetch fork so workers share them."""
    with open(os.path.join(dir_path, "labels.json")) as f:
        meta = json.load(f)
    out = []
    for name in sorted(meta):
        img = _to_height_32(_gray_u8(os.path.join(dir_path, name)))
        entry = meta[name]
        label = entry["label"] if isinstance(entry, dict) else str(entry)
        out.append((img, label))
    return out


def _device_batch(batch, device) -> tuple:
    return tuple(torch.as_tensor(np.asarray(a)).to(device) for a in batch)


def train_crnn(args, source=None, val=None) -> Dict[str, Any]:
    """The recognizer's loop. ``source`` (``get()`` and ``set()``) gives
    (crops u8, labels, label_lens, frame_lens) batches, by default the
    synthetic generator in forked workers; ``val`` is (crops, refs) of the
    validation set, by default 64 synthetic crops (seed 999_999) at the
    widest width."""
    from bbocr_tpu_torch.decode import ctc_greedy_decode
    from bbocr_tpu_torch.models import CRNN
    from bbocr_tpu_torch.models.charset import CHARSETS
    from bbocr_tpu_torch.models.init import init_crnn
    from bbocr_tpu_torch.train import make_optimizer
    from bbocr_tpu_torch.train.synth import SynthConfig, TextLineGenerator
    from bbocr_tpu_torch.train.trainer import crnn_logits, make_crnn_train_step, to_params, to_tree
    from bbocr_tpu_torch.utils.cer import corpus_cer
    from bbocr_tpu_torch.utils.checkpoint import load_params, save_params

    device = torch.device(args.device)
    cfg = SynthConfig(charset=CHARSETS[args.charset])
    if args.charset == "cjk" and source is None:
        # Refuse to synthesize tofu: the generator renders with the system
        # fonts, and a head trained on missing-glyph boxes is worse than no
        # head.
        from bbocr_tpu_torch.train.synth import _find_fonts, require_pillow

        ImageFont, = require_pillow("ImageFont")

        def covers(path, ch="カ"):  # katakana KA
            try:
                f = ImageFont.truetype(path, 24)
                missing = f.getmask("￿").getbbox()
                got = f.getmask(ch).getbbox()
                return got is not None and got != missing
            except Exception:
                return False

        if not any(covers(p) for p in _find_fonts()):
            raise SystemExit(
                "--charset cjk: no installed font covers CJK glyphs; install "
                "one (e.g. Noto Sans CJK) before training this head"
            )

    widths = [int(w) for w in str(args.width).split(",")]

    pipe_data, pipe_frac = None, 0.0
    if getattr(args, "pipeline_crops", None):
        spec = str(args.pipeline_crops).split(":")
        try:
            pipe_data = _load_pipeline_crops(spec[0])
            pipe_frac = float(spec[1]) if len(spec) > 1 else 0.25
        except (OSError, ValueError, KeyError) as e:
            print(f"pipeline-crops disabled ({args.pipeline_crops}: {e})", flush=True)
        else:
            print(f"pipeline crops: {len(pipe_data)} from {spec[0]} at frac {pipe_frac}", flush=True)
            if not pipe_data:
                pipe_data = None

    def make_batch(seed):
        gen = TextLineGenerator(cfg, seed=seed)
        width = widths[seed % len(widths)]
        crops, labels, label_lens, frame_lens = gen.batch(args.batch, width=width)
        if pipe_data is not None and pipe_frac > 0:
            # Mix in crops that went through the real serving pipeline
            # (letterbox -> detect -> CC quads -> rectify).
            rng = np.random.default_rng(seed ^ 0x5EED)
            max_chars = max(1, min(cfg.max_label_len, (width // 4 - 2) // 2))
            n_mix = int(args.batch * pipe_frac)
            rows = rng.choice(args.batch, size=n_mix, replace=False)
            for row in rows:
                for _ in range(8):  # find a crop that fits this width bucket
                    img, label = pipe_data[int(rng.integers(len(pipe_data)))]
                    enc = cfg.charset.encode(label)
                    if img.shape[1] <= width and 0 < len(enc) <= max_chars:
                        break
                else:
                    continue
                w_img = img.shape[1]
                crops[row] = 0.0
                crops[row][:, :w_img] = img.astype(np.float32)
                crops[row][:, w_img:] = crops[row][:, w_img - 1 : w_img]
                labels[row] = 0
                labels[row][: len(enc)] = enc
                label_lens[row] = len(enc)
        return crops.astype(np.uint8), labels, label_lens, frame_lens

    # fork workers BEFORE the first CUDA call (see _prefetch)
    q, stop = _source(args, make_batch, source)

    crnn = CRNN(num_classes=cfg.charset.num_classes).to(device)
    tree = init_crnn(args.seed, cfg.charset.num_classes)
    if args.init_from:
        tree = load_params(args.init_from)
        print(f"initialized from {args.init_from}", flush=True)
    params = to_params(crnn, tree, device)
    tx = make_optimizer(_train_config(args))
    opt_state = tx.init(params)
    params, opt_state, start_step = _maybe_resume(args, params, opt_state)
    step_fn = make_crnn_train_step(crnn, tx)

    if val is None:  # fixed validation set (largest width bucket)
        val_gen = TextLineGenerator(cfg, seed=999_999)
        val_crops, val_labels, val_label_lens, _ = val_gen.batch(64, width=max(widths))
        val = (val_crops, [cfg.charset.decode_ids(val_labels[i][: val_label_lens[i]]) for i in range(64)])
    val_crops, val_refs = val
    # Real-crop validation: synthetic val CER was 20x better than CER on
    # real rectified crops, so the synthetic number alone cannot gate
    # quality work.
    real_crops = real_refs = None
    if getattr(args, "val_real", None):
        try:
            real_crops, real_refs = _load_real_val(args.val_real, max(widths))
            if not real_refs:
                real_crops = real_refs = None
        except (OSError, ValueError, KeyError) as e:
            print(f"val-real disabled ({args.val_real}: {e})", flush=True)
        else:
            print(f"real val: {len(real_refs or [])} crops from {args.val_real}", flush=True)

    @torch.no_grad()
    def predict(p, crops):
        logits = crnn_logits(crnn, p, torch.as_tensor(np.asarray(crops, np.float32)).to(device))
        lengths = torch.full((logits.shape[0],), logits.shape[1], dtype=torch.int32, device=device)
        ids, lens, _ = ctc_greedy_decode(logits, lengths)
        return ids.cpu().numpy(), lens.cpu().numpy()

    name = "crnn.npz" if args.charset == "en" else f"crnn_{args.charset}.npz"
    t0 = time.time()
    losses = []  # device tensors; only synced at log points
    log: List[Dict[str, Any]] = []
    best_real_cer = [float("inf")]
    for step in range(start_step + 1, args.steps + 1):
        crops, labels, label_lens, frame_lens = _device_batch(q.get(), device)
        params, opt_state, loss = step_fn(params, opt_state, crops, labels, label_lens, frame_lens)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps:
            mean_loss = float(np.mean([float(l) for l in losses]))
            losses = []
            ids, lens = predict(params, val_crops)
            hyps = [cfg.charset.decode_ids(ids[i][: lens[i]]) for i in range(len(val_refs))]
            val_cer = corpus_cer(val_refs, hyps)
            real_part = ""
            if real_crops is not None:
                rids, rlens = predict(params, real_crops)
                rhyps = [cfg.charset.decode_ids(rids[i][: rlens[i]]) for i in range(len(real_refs))]
                real_cer = corpus_cer(real_refs, rhyps)
                real_part = f"real_cer {real_cer:.4f} "
                # Track the real-CER optimum separately: the synthetic and
                # real curves can diverge, so the last checkpoint is not
                # necessarily the shippable one.
                if real_cer < best_real_cer[0]:
                    best_real_cer[0] = real_cer
                    os.makedirs(args.out, exist_ok=True)
                    save_params(os.path.join(args.out, "crnn_best_real.npz"), to_tree(crnn, params))
                    with open(os.path.join(args.out, "best_real.json"), "w") as f:
                        json.dump({"step": step, "real_cer": round(real_cer, 5)}, f)
            rate = (step - start_step) * args.batch / (time.time() - t0)
            log.append({"step": step, "loss": mean_loss, "val_cer": val_cer, "rate": rate})
            print(
                f"step {step:6d} loss {mean_loss:8.4f} "
                f"val_cer {val_cer:.4f} {real_part}crops/s {rate:8.1f} "
                f"sample {hyps[0]!r} vs {val_refs[0]!r}",
                flush=True,
            )
        if step % args.save_every == 0 or step == args.steps or _STOP_REQUESTED.is_set():
            os.makedirs(args.out, exist_ok=True)
            save_params(os.path.join(args.out, name), to_tree(crnn, params))
            _maybe_save_state(args, step, params, opt_state)
        if _STOP_REQUESTED.is_set():
            print(f"stopped early at step {step}", flush=True)
            break
    stop.set()
    print(f"saved {os.path.join(args.out, name)}")
    return {"path": os.path.join(args.out, name), "start_step": start_step, "log": log}


def train_craft(args, source=None) -> Dict[str, Any]:
    """The detector's loop; ``source`` gives (pages u8, maps u8) batches,
    by default the synthetic page generator in forked workers."""
    from bbocr_tpu_torch.models.craft import CRAFT, CRAFTLite
    from bbocr_tpu_torch.models.init import init_craft
    from bbocr_tpu_torch.train import make_optimizer
    from bbocr_tpu_torch.train.synth import PageGenerator, SynthConfig
    from bbocr_tpu_torch.train.trainer import craft_maps, craft_model, make_craft_train_step, to_params, to_tree
    from bbocr_tpu_torch.utils.checkpoint import load_params, save_params

    device = torch.device(args.device)
    # Page-size menu (comma lists): covers letterboxed to serving canvases
    # carry display glyphs up to ~180px, so train at more than one size;
    # keep the menu to 2-3 entries.
    hs = [int(x) for x in str(args.page_h).split(",")]
    ws = [int(x) for x in str(args.page_w).split(",")]
    if len(hs) != len(ws):
        raise SystemExit("--page-h and --page-w lists must have equal length")

    def make_batch(seed):
        gen = PageGenerator(SynthConfig(), seed=seed)
        k = seed % len(hs)
        pages, maps = gen.batch(args.batch, hs[k], ws[k])
        # u8 pages + u8-quantized heatmaps (craft_loss dequantizes)
        return pages.astype(np.uint8), np.round(maps * 255.0).astype(np.uint8)

    q, stop = _source(args, make_batch, source)

    lite = getattr(args, "arch", "vgg") == "lite"
    craft = (CRAFTLite() if lite else CRAFT()).to(device)
    tree = init_craft(args.seed, lite=lite)
    if args.init_from:
        tree = load_params(args.init_from)
        print(f"initialized from {args.init_from}", flush=True)
    params = to_params(craft, tree, device)
    tx = make_optimizer(_train_config(args))
    opt_state = tx.init(params)
    params, opt_state, start_step = _maybe_resume(args, params, opt_state)
    step_fn = make_craft_train_step(craft, tx, neg_ratio=args.neg_ratio)

    # Optional distillation: blend the GT heatmaps with a trained teacher's
    # predictions (--distill-from, usually the big VGG CRAFT) so the lite
    # student also learns the teacher's score SHAPES. Maps come back
    # u8-quantized.
    teacher_fn = None
    if getattr(args, "distill_from", None):
        ttree = load_params(args.distill_from)
        teacher = craft_model(ttree).to(device)
        tparams = to_params(teacher, ttree, device)

        @torch.no_grad()
        def teacher_fn(pages_u8):
            m = craft_maps(teacher, tparams, torch.as_tensor(pages_u8).to(device))
            return torch.clamp(torch.round(m * 255.0), 0, 255).to(torch.uint8).cpu().numpy()

        print(f"distilling from {args.distill_from} (w={args.distill_weight})", flush=True)

    t0 = time.time()
    losses = []
    log: List[Dict[str, Any]] = []
    for step in range(start_step + 1, args.steps + 1):
        pages, maps = q.get()
        if teacher_fn is not None:
            t = teacher_fn(pages)
            w = float(args.distill_weight)
            maps = np.round((1.0 - w) * maps.astype(np.float32) + w * t.astype(np.float32)).astype(np.uint8)
        pages, maps = _device_batch((pages, maps), device)
        params, opt_state, loss = step_fn(params, opt_state, pages, maps)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps:
            mean_loss = float(np.mean([float(l) for l in losses]))
            losses = []
            rate = (step - start_step) * args.batch / (time.time() - t0)
            log.append({"step": step, "loss": mean_loss, "rate": rate})
            print(f"step {step:6d} loss {mean_loss:8.5f} pages/s {rate:7.1f}", flush=True)
        if step % args.save_every == 0 or step == args.steps or _STOP_REQUESTED.is_set():
            os.makedirs(args.out, exist_ok=True)
            save_params(os.path.join(args.out, "craft.npz"), to_tree(craft, params))
            _maybe_save_state(args, step, params, opt_state)
        if _STOP_REQUESTED.is_set():
            print(f"stopped early at step {step}", flush=True)
            break
    stop.set()
    print(f"saved {os.path.join(args.out, 'craft.npz')}")
    return {"path": os.path.join(args.out, "craft.npz"), "start_step": start_step, "log": log}


def train_vlm(args, source=None, val=None) -> Dict[str, Any]:
    """The PageReader's loop; ``source`` gives (pages u8, tokens, tok_lens
    [, char_labels, char_lens]) batches, by default the synthetic labeled
    pages; ``val`` is (pages, refs), by default 8 synthetic pages (seed
    999_999)."""
    from bbocr_tpu_torch.models.init import init_pagereader
    from bbocr_tpu_torch.models.vlm import PageReader, decode_ids, greedy_generate
    from bbocr_tpu_torch.train import make_optimizer
    from bbocr_tpu_torch.train.synth import PageGenerator, SynthConfig
    from bbocr_tpu_torch.train.trainer import make_vlm_train_step, to_params, to_tree
    from bbocr_tpu_torch.utils.checkpoint import load_params, save_params

    device = torch.device(args.device)
    h, w = int(str(args.page_h).split(",")[0]), int(str(args.page_w).split(",")[0])
    aux_w = float(getattr(args, "vlm_ctc_weight", 0.0) or 0.0)

    def make_batch(seed):
        gen = PageGenerator(SynthConfig(), seed=seed)
        out = gen.batch_labeled(args.batch, h, w, target=args.vlm_target, with_ctc=aux_w > 0)
        return (out[0].astype(np.uint8),) + tuple(out[1:])

    q, stop = _source(args, make_batch, source)

    model = PageReader().to(device)
    tree = init_pagereader(args.seed, with_ctc=aux_w > 0)
    if args.init_from:
        loaded = load_params(args.init_from)
        if aux_w > 0 and "ctc_head" not in loaded.get("params", {}):
            # a pre-aux checkpoint into the aux recipe: keep the fresh CTC
            # head, take everything else from the checkpoint
            loaded["params"]["ctc_head"] = tree["params"]["ctc_head"]
        tree = loaded
        print(f"initialized from {args.init_from}", flush=True)
    params = to_params(model, tree, device)
    if not any(k.startswith("ctc_head.") for k in params):
        model.ctc_head = None
    tx = make_optimizer(_train_config(args))
    opt_state = tx.init(params)
    params, opt_state, start_step = _maybe_resume(args, params, opt_state)
    step_fn = make_vlm_train_step(model, tx, ctc_weight=aux_w)

    if val is None:
        val_gen = PageGenerator(SynthConfig(), seed=999_999)
        val_pages, val_tokens, _ = val_gen.batch_labeled(8, h, w, target=args.vlm_target)
        val = (val_pages, [decode_ids(val_tokens[i]) for i in range(8)])
    val_pages, val_refs = val

    @torch.no_grad()
    def val_exact(p):
        for k, v in model.state_dict().items():
            v.copy_(p[k])
        ids = greedy_generate(model, torch.as_tensor(np.asarray(val_pages, np.float32)).to(device)[..., None]).cpu()
        hyps = [decode_ids(ids[i]) for i in range(len(val_refs))]

        def fields(s):
            try:
                return json.loads(s)
            except Exception:
                return {}

        hits = total = 0
        for r, hyp in zip(val_refs, hyps):
            fr, fh = fields(r), fields(hyp)
            for k, v in fr.items():
                total += 1
                hits += fh.get(k) == v
        return hits / max(total, 1), hyps[0]

    name = "vlm.npz" if args.vlm_target == "json" else "vlm_read.npz"
    t0 = time.time()
    losses = []
    log: List[Dict[str, Any]] = []
    for step in range(start_step + 1, args.steps + 1):
        batch = _device_batch(q.get(), device)
        params, opt_state, loss = step_fn(params, opt_state, *batch)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps:
            mean_loss = float(np.mean([float(l) for l in losses]))
            losses = []
            acc, sample = val_exact(params)
            rate = (step - start_step) * args.batch / (time.time() - t0)
            log.append({"step": step, "loss": mean_loss, "val_field_acc": acc, "rate": rate})
            print(
                f"step {step:6d} loss {mean_loss:8.4f} val_field_acc {acc:.3f} "
                f"pages/s {rate:7.1f} sample {sample[:70]!r}",
                flush=True,
            )
        if step % args.save_every == 0 or step == args.steps or _STOP_REQUESTED.is_set():
            os.makedirs(args.out, exist_ok=True)
            save_params(os.path.join(args.out, name), to_tree(model, params))
            _maybe_save_state(args, step, params, opt_state)
        if _STOP_REQUESTED.is_set():
            print(f"stopped early at step {step}", flush=True)
            break
    stop.set()
    print(f"saved {os.path.join(args.out, name)}")
    return {"path": os.path.join(args.out, name), "start_step": start_step, "log": log}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train bbocr_tpu_torch models on synthetic data")
    p.add_argument("--component", choices=["crnn", "craft", "vlm"], required=True)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--width", type=str, default="256",
                   help="crnn crop width, or comma list to mix buckets (e.g. 64,128,256,384)")
    p.add_argument("--page-h", type=str, default="256",
                   help="craft page height, or comma list to mix sizes (e.g. 256,512)")
    p.add_argument("--page-w", type=str, default="192",
                   help="craft page width(s), zipped with --page-h")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="checkpoints")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--data-threads", type=int, default=4)
    p.add_argument("--init-from", type=str, default=None,
                   help="warm-start params from an .npz checkpoint")
    p.add_argument("--schedule", choices=["constant", "cosine"], default="constant",
                   help="LR schedule (cosine = warmup then cosine decay over --steps)")
    p.add_argument("--warmup", type=int, default=0, help="linear warmup steps")
    p.add_argument("--charset", choices=["en", "latin_ext", "cjk"], default="en",
                   help="recognizer head charset (cjk requires fonts with CJK coverage)")
    p.add_argument("--neg-ratio", type=float, default=3.0,
                   help="craft loss: weight on background (false-positive) MSE")
    p.add_argument("--arch", choices=["vgg", "lite"], default="vgg",
                   help="craft architecture: vgg = full VGG16 CRAFT, lite = CRAFTLite "
                        "(the serving engine picks the arch from the checkpoint's param tree)")
    p.add_argument("--distill-from", type=str, default=None,
                   help="craft: teacher checkpoint whose predicted heatmaps "
                        "are blended into the training targets")
    p.add_argument("--distill-weight", type=float, default=0.5,
                   help="blend weight on the teacher's heatmaps (0..1)")
    p.add_argument("--vlm-ctc-weight", type=float, default=0.0,
                   help="weight of the encoder CTC auxiliary loss (0 = off); "
                        "grounds the encoder tokens in character identity")
    p.add_argument("--vlm-target", choices=["json", "text"], default="json",
                   help="vlm training target: json = metadata (end task), "
                        "text = literal page transcription (reading curriculum)")
    p.add_argument("--pipeline-crops", type=str, default=None,
                   help="DIR[:frac] of pipeline-consistent crops to mix into crnn batches")
    p.add_argument("--val-real", type=str, default=None,
                   help="dir of harvested real crops to report real_cer on during crnn training")
    p.add_argument("--state-dir", type=str, default=None,
                   help="train-state dir: saves full resumable state every "
                        "--save-every and auto-resumes from the latest checkpoint")
    p.add_argument("--device", type=str, default="cuda", help="torch device to train on")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    _install_sigterm_handler()
    if args.component == "crnn":
        train_crnn(args)
    elif args.component == "vlm":
        train_vlm(args)
    else:
        train_craft(args)
    # Force a clean exit: terminated data workers can leave the queue's
    # feeder thread wedged and the interpreter hanging after all work is
    # done and saved.
    import sys

    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
