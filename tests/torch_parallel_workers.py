"""Rank workers of ``tests/test_torch_parallel.py``.

Each rank runs in a spawned process, so that it imports the port and
never JAX (which the test process holds). ``spawn_ranks`` starts one
process per rank of a gloo group (a ``file://`` store in the work
directory, a 60 s group timeout, one torch thread per rank), joins them
with a wall limit, kills every rank on a timeout or on one rank's
failure, and raises naming the rank. Rank 0 writes what the test compares
(``result.json``, ``result.npz``) into the work directory.
"""

from __future__ import annotations

import datetime
import json
import multiprocessing as mp
import os
import time
import traceback

import numpy as np

MESH_DP, MESH_TP = 4, 2
# the JAX package's dp=4, tp=2 step (scripts/torch_port_reference.py --mesh)
JAX_STEP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "mesh_jax_f32.npz")
COVERS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "real", "covers")
CANVAS = (128, 96)


def spawn_ranks(target, world: int, workdir: str, limit_s: float) -> None:
    ctx = mp.get_context("spawn")
    store = os.path.join(workdir, "store")
    procs = [ctx.Process(target=_entry, args=(target, rank, world, store, workdir), daemon=True) for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit_s
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            for rank, p in enumerate(procs):
                if p.exitcode not in (None, 0):
                    failed = f"rank {rank} exited with code {p.exitcode}: {_error(workdir, rank)}"
                    break
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        for rank, p in enumerate(procs):
            if failed is None and p.exitcode not in (None, 0):
                failed = f"rank {rank} exited with code {p.exitcode}: {_error(workdir, rank)}"
        if failed is None and any(p.is_alive() for p in procs):
            alive = [rank for rank, p in enumerate(procs) if p.is_alive()]
            failed = f"ranks {alive} still running after {limit_s} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(5)
    if failed:
        raise AssertionError(failed)


def _error(workdir: str, rank: int) -> str:
    path = os.path.join(workdir, f"rank{rank}.err")
    return open(path).read()[-3000:] if os.path.exists(path) else "(no traceback)"


def _entry(target, rank: int, world: int, store: str, workdir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        target(rank, workdir)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _mesh():
    from bbocr_tpu_torch.parallel import MeshConfig, make_mesh

    return make_mesh(MeshConfig(dp=MESH_DP, tp=MESH_TP))


def _results(res) -> list:
    return [{"texts": [t for _, t, _ in r], "quads": [np.asarray(q, np.float64).tolist() for q, _, _ in r],
             "confidences": [float(c) for _, _, c in r]} for r in res]


def engine_config():
    import torch

    from bbocr_tpu_torch.runtime import EngineConfig
    from bbocr_tpu_torch.runtime.bucketing import CanvasSpec

    return EngineConfig(canvases=(CanvasSpec(*CANVAS),), width_buckets=(32, 64), batch_capacities=(4, 8),
                        compute_dtype=torch.float32, host_rectify=True, decoder="greedy")


def noise_photos():
    rng = np.random.default_rng(1)  # tests/test_runtime.py's photos
    return [rng.integers(0, 255, (200, 150), np.uint8) for _ in range(5)]


def engine_worker(rank: int, workdir: str) -> None:
    """The dp=4, tp=2 engine against the unsharded one on the same
    parameters: ``readtext_batch`` of the five noise photos and of two
    covers, ``readtext_stream``, the detect maps of the photos' canvases and
    recognize on crops of a cover (rank 0 records both)."""
    import torch

    from bbocr_tpu_torch.io import imread_gray
    from bbocr_tpu_torch.models.convert import craft_state_dict, crnn_state_dict
    from bbocr_tpu_torch.parallel.sharding import param_shardings
    from bbocr_tpu_torch.runtime import OCREngine
    from bbocr_tpu_torch.utils.checkpoint import load_params

    craft, crnn = (load_params(os.path.join(workdir, f"{m}.npz")) for m in ("craft", "crnn"))
    cfg = engine_config()
    mesh = _mesh()
    sharded = OCREngine(craft, crnn, cfg, device="cpu", mesh=mesh)
    photos = noise_photos()
    covers = [imread_gray(os.path.join(COVERS, name)) for name in ("book2.png", "book4.png")]
    canvas = torch.from_numpy(np.random.default_rng(2).uniform(0, 255, (8, *CANVAS)).astype(np.float32))
    crops = torch.from_numpy(np.stack([covers[0][40:72, 20:84], covers[0][100:132, 0:64], covers[1][10:42, 30:94],
                                       np.full((32, 64), 128, np.uint8)] * 2).astype(np.float32))
    lengths, valid = torch.full((8,), 15), torch.tensor([True] * 7 + [False])

    def run(engine, split):
        call = (lambda fn, *rows: engine._dp_rows(fn, *rows)) if split else (lambda fn, *rows: fn(*rows))
        masks, regions = call(engine.detect, canvas)
        ids, lens, conf = call(engine.recognize, crops, lengths, valid)
        return {
            "photos": _results(engine.readtext_batch(photos)),
            "covers": _results(engine.readtext_batch(covers)),
            "stream": [_results(r) for r in engine.readtext_stream([covers[:1], [], covers[1:]])],
        }, {"masks": masks.numpy(), "regions": regions.numpy(), "ids": ids.numpy(), "lens": lens.numpy(),
            "conf": conf.numpy()}

    got, got_arrays = run(sharded, True)
    if rank != 0:
        return
    specs = {
        model: {k: list(s.spec) for k, s in param_shardings(sd, mesh).items()}
        for model, sd in (("craft", craft_state_dict(craft)), ("crnn", crnn_state_dict(crnn)))
    }
    want, want_arrays = run(OCREngine(craft, crnn, cfg, device="cpu"), False)
    with open(os.path.join(workdir, "result.json"), "w") as f:
        json.dump({"sharded": got, "unsharded": want, "specs": specs}, f)
    np.savez(os.path.join(workdir, "result.npz"), **{f"sharded/{k}": v for k, v in got_arrays.items()},
             **{f"unsharded/{k}": v for k, v in want_arrays.items()})


def _state(workdir: str):
    import torch

    from bbocr_tpu_torch.models import CRAFT, CRNN
    from bbocr_tpu_torch.train import TrainConfig, TrainState, make_optimizer
    from bbocr_tpu_torch.train.trainer import to_params
    from bbocr_tpu_torch.utils.checkpoint import load_params

    craft, crnn = CRAFT(), CRNN(num_classes=97)
    craft.dtype = crnn.dtype = torch.float32
    cp = to_params(craft, load_params(os.path.join(workdir, "train_craft.npz")), "cpu")
    rp = to_params(crnn, load_params(os.path.join(workdir, "train_crnn.npz")), "cpu")
    tx = make_optimizer(TrainConfig())
    state = TrainState(torch.zeros((), dtype=torch.int32), cp, rp, tx.init((cp, rp)))
    with np.load(os.path.join(workdir, "batch.npz")) as data:
        batch = {k: torch.from_numpy(data[k]) for k in data.files}
    return craft, crnn, tx, state, batch


def _flax_trees(craft, crnn, state) -> dict:
    """The state's parameters and Adam moments as flax trees (numpy)."""
    from bbocr_tpu_torch.train.trainer import to_tree

    adam = state.opt_state[1][0]
    out = {}
    for kind, (c, r) in (("params", (state.craft_params, state.crnn_params)), ("mu", adam.mu), ("nu", adam.nu)):
        out[kind] = {"craft": to_tree(craft, c), "crnn": to_tree(crnn, r)}
    return out


def step_worker(rank: int, workdir: str) -> None:
    """One float32 joint step on the dp=4, tp=2 mesh; rank 0 then takes
    the unsharded step on the same state and batch and records both."""
    import torch

    from bbocr_tpu_torch.train import make_joint_train_step

    craft, crnn, tx, state, batch = _state(workdir)
    mesh = _mesh()
    step = make_joint_train_step(craft, crnn, tx, mesh=mesh, state_example=state)
    new, metrics = step(state, batch)
    if rank != 0:
        return
    torch.set_num_threads(4)
    ref, ref_metrics = make_joint_train_step(craft, crnn, tx)(state, batch)
    got, want = _flax_trees(craft, crnn, new), _flax_trees(craft, crnn, ref)
    with np.load(JAX_STEP) as data:
        recorded = {k: data[k] for k in data.files}
    diffs, samples = {}, {}
    for kind in ("params", "mu", "nu"):
        for model in ("craft", "crnn"):
            for path, value in _leaves(got[kind][model]["params"]):
                name = f"{kind}/{model}/{path}"
                diffs[name] = value
                samples[name] = value.ravel()[recorded[f"{name}/idx"]]
    flat_want = {f"{kind}/{model}/{path}": v for kind in ("params", "mu", "nu") for model in ("craft", "crnn")
                 for path, v in _leaves(want[kind][model]["params"])}
    report = {}
    for name, value in diffs.items():
        ref_value = flat_want[name]
        err = np.abs(value - ref_value)
        if name.startswith("params/"):
            mu_got, mu_want = diffs["mu/" + name[7:]], flat_want["mu/" + name[7:]]
            exempt, noisy = first_move_exempt(mu_got, mu_want)
            report[name] = [float(np.where(exempt, 0.0, err).max(initial=0.0)), int(exempt.sum()), int(noisy.sum())]
        else:
            report[name] = [float(err.max(initial=0.0)), 0, 0]
    np.savez(os.path.join(workdir, "result.npz"), **samples)
    with open(os.path.join(workdir, "result.json"), "w") as f:
        json.dump({"sharded": {k: float(v) for k, v in metrics.items()},
                   "unsharded": {k: float(v) for k, v in ref_metrics.items()},
                   "steps": [int(new.step), int(ref.step)], "diffs": report}, f)


# Adam's first move, lr * g / (|g| + 1e-8), follows the rounding of a
# gradient that lies within its rounding noise. At this fresh
# initialisation CRAFT's first two convs' step-1 gradients carry about
# 1e-5 of it (the unsharded step with 1 and with 4 torch threads differs by
# 8.2e-6 there). So, as chip_smoke.py phase 14a does, an element is exempt
# where its step-1 gradient (mu = 0.1 g) is below 1e-6 or the two
# gradients differ in sign, and also where they differ by more than a
# tenth of their size; the exempt elements are counted.
def first_move_exempt(mu_got: np.ndarray, mu_want: np.ndarray):
    """(exempt, noisy): the exempt elements, and those of them exempt only
    because their gradients differ by more than a tenth."""
    rule = (np.abs(mu_want) < 1e-7) | (np.sign(mu_got) != np.sign(mu_want))
    noisy = ~rule & (np.abs(mu_got - mu_want) > 0.1 * np.abs(mu_want))
    return rule | noisy, noisy


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(tree[k], np.float32)
