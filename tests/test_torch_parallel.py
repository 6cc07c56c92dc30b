"""Multi-device serving and training of the port (``parallel/``, the
engine's and the trainer's mesh) against the JAX package.

The JAX package shards over a mesh of 8 virtual CPU devices (the
conftest's); the port runs SPMD over a gloo group of 8 spawned CPU
processes, one per rank, with ``dp=4, tp=2``. The rank workers live in
``tests/torch_parallel_workers.py``, which imports no JAX. Held:

- ``make_mesh``'s errors are JAX's;
- ``param_shardings`` on the port's parameter dicts splits the leaves
  JAX's splits, along the axis the weight bridge puts JAX's last axis on;
- the sharded engine reads as the port's unsharded engine and as the JAX
  package's sharded engine (recorded, ``tests/data/mesh_jax_f32.json``):
  texts equal, boxes within 1e-3, confidences within 1e-3;
- one float32 joint step: loss within 1e-5 relative of the unsharded
  step's, every parameter and Adam moment within 1e-5, and the recorded
  elements of the JAX package's dp=4, tp=2 step. Parameters whose Adam
  first move follows rounding are exempt (``torch_parallel_workers.
  first_move_exempt``: chip_smoke.py phase 14a's rule, and gradients that
  differ by over a tenth, counted and bounded);
- a 1x1 mesh (one rank) is the unsharded path bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_workers as workers
from bbocr_tpu.parallel import MeshConfig as JaxMeshConfig
from bbocr_tpu.parallel import make_mesh as jax_make_mesh
from bbocr_tpu.parallel import param_shardings as jax_param_shardings
from bbocr_tpu_torch.models.convert import craft_state_dict, crnn_state_dict
from bbocr_tpu_torch.parallel import MeshConfig, make_mesh
from bbocr_tpu_torch.parallel.mesh import single_device_mesh
from bbocr_tpu_torch.utils.checkpoint import _flatten

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
WORLD = workers.MESH_DP * workers.MESH_TP
SPAWN_LIMIT_S = 150.0


def _save(path, tree):
    np.savez(path, **_flatten(jax.device_get(tree)))


@pytest.fixture(scope="module")
def jax_engine_params(tmp_path_factory):
    """``OCREngine.create(seed=0)``'s parameters, as the JAX mesh test
    builds its engines, saved for the ranks."""
    from bbocr_tpu.runtime import EngineConfig, OCREngine
    from bbocr_tpu.runtime.bucketing import CanvasSpec

    cfg = EngineConfig(canvases=(CanvasSpec(*workers.CANVAS),), width_buckets=(32, 64), batch_capacities=(4, 8),
                       compute_dtype=jnp.float32)
    ref = OCREngine.create(seed=0, config=cfg)
    return jax.device_get(ref.craft_params), jax.device_get(ref.crnn_params)


@pytest.mark.parametrize("n, dp, tp", [(8, None, 3), (8, 3, 2), (8, 2, 2), (6, 4, None)])
def test_make_mesh_errors_are_jax_errors(n, dp, tp):
    config = {"dp": dp} if tp is None else {"dp": dp, "tp": tp}
    with pytest.raises(ValueError) as want:
        jax_make_mesh(JaxMeshConfig(**config), devices=jax.devices()[:n])
    with pytest.raises(ValueError) as got:
        make_mesh(MeshConfig(**config), devices=list(range(n)))
    assert str(got.value) == str(want.value)


def test_joint_step_without_state_example_raises_as_jax():
    from bbocr_tpu.models import CRAFT as JaxCRAFT
    from bbocr_tpu.models import CRNN as JaxCRNN
    from bbocr_tpu.train import TrainConfig as JaxTrainConfig
    from bbocr_tpu.train import make_joint_train_step as jax_joint
    from bbocr_tpu.train import make_optimizer as jax_optimizer
    from bbocr_tpu_torch.models import CRAFT, CRNN
    from bbocr_tpu_torch.train import TrainConfig, make_joint_train_step, make_optimizer

    with pytest.raises(ValueError) as want:
        jax_joint(JaxCRAFT(), JaxCRNN(num_classes=97), jax_optimizer(JaxTrainConfig()),
                  mesh=jax_make_mesh(JaxMeshConfig(dp=4, tp=2)))
    with pytest.raises(ValueError) as got:
        make_joint_train_step(CRAFT(), CRNN(num_classes=97), make_optimizer(TrainConfig()), mesh=object())
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def engine_run(jax_engine_params, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("mesh_engine"))
    for name, tree in zip(("craft", "crnn"), jax_engine_params):
        _save(os.path.join(workdir, f"{name}.npz"), tree)
    workers.spawn_ranks(workers.engine_worker, WORLD, workdir, SPAWN_LIMIT_S)
    with open(os.path.join(workdir, "result.json")) as f:
        result = json.load(f)
    with np.load(os.path.join(workdir, "result.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    return result, arrays


def _hold(got: list, want: list, atol: float = 1e-3) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["texts"] == w["texts"]
        assert len(g["quads"]) == len(w["quads"])
        for gq, wq in zip(g["quads"], w["quads"]):
            np.testing.assert_allclose(gq, wq, rtol=0, atol=atol)
        np.testing.assert_allclose(g["confidences"], w["confidences"], rtol=0, atol=atol)


def test_sharded_engine_reads_as_unsharded_and_jax(engine_run):
    result, arrays = engine_run
    with open(os.path.join(DATA, "mesh_jax_f32.json")) as f:
        jax_run = json.load(f)
    sharded, unsharded = result["sharded"], result["unsharded"]
    _hold(sharded["photos"], unsharded["photos"])
    _hold(sharded["photos"], jax_run["engine"])
    _hold(sharded["covers"], unsharded["covers"])
    _hold([r for batch in sharded["stream"] for r in batch], [r for batch in unsharded["stream"] for r in batch])
    assert len(sharded["stream"]) == 3 and sharded["stream"][1] == []
    # the split products against the whole ones: detect and recognize
    np.testing.assert_array_equal(arrays["sharded/masks"], arrays["unsharded/masks"])
    assert np.abs(arrays["sharded/regions"].astype(int) - arrays["unsharded/regions"]).max() <= 1
    for k in ("ids", "lens"):
        np.testing.assert_array_equal(arrays[f"sharded/{k}"], arrays[f"unsharded/{k}"])
    np.testing.assert_allclose(arrays["sharded/conf"], arrays["unsharded/conf"], rtol=0, atol=1e-5)


def _jax_specs(tree, mesh) -> dict:
    from bbocr_tpu_torch.models.convert import _leaves

    shardings = jax_param_shardings(tree, mesh)
    flat = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        flat["/".join(str(getattr(k, "key", k)) for k in path[1:])] = tuple(sh.spec)
    assert set(flat) == {k for k, _ in _leaves(tree["params"])}
    return flat


@pytest.mark.parametrize("model", ["craft", "crnn"])
def test_param_shardings_follow_jax_through_the_bridge(model, jax_engine_params, engine_run):
    """Each JAX leaf goes through the weight bridge twice: filled with its
    leaf number (which port key it becomes) and with the index along its
    last axis (which port axis that is). The port splits that axis over tp
    exactly where JAX splits its last one."""
    from bbocr_tpu_torch.models.convert import _leaves

    tree = jax_engine_params[0 if model == "craft" else 1]
    to_port = craft_state_dict if model == "craft" else crnn_state_dict
    want = _jax_specs(tree, jax_make_mesh(JaxMeshConfig(dp=4, tp=2)))
    paths = [p for p, _ in _leaves(tree["params"])]

    def filled(fn):
        def walk(node, prefix=""):
            return {k: walk(v, f"{prefix}{k}/") if isinstance(v, dict) else fn(prefix + k, np.asarray(v))
                    for k, v in node.items()}
        return {"params": walk(tree["params"])}

    ids = to_port(filled(lambda p, v: np.full(v.shape, paths.index(p), np.float32)))
    axes = to_port(filled(lambda p, v: np.broadcast_to(np.arange(v.shape[-1], dtype=np.float32), v.shape)))
    specs = engine_run[0]["specs"][model]
    split = 0
    for key, t in ids.items():
        path = paths[int(t.reshape(-1)[0])]
        jax_split = want[path][-1:] == ("tp",) if want[path] else False
        varying = [a for a in range(t.ndim) if t.ndim > 1 and axes[key].shape[a] > 1
                   and not torch.equal(axes[key].narrow(a, 0, 1).expand_as(axes[key]), axes[key])]
        port_spec = specs[key]
        assert ("tp" in port_spec) == jax_split, key
        if jax_split:
            assert varying == [port_spec.index("tp")], key
            split += 1
    assert split == (9 if model == "craft" else 8)


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    from bbocr_tpu.train import create_train_state
    from bbocr_tpu.train.synth import PageGenerator, TextLineGenerator

    workdir = str(tmp_path_factory.mktemp("mesh_step"))
    state, *_ = create_train_state(dtype=jnp.float32)
    _save(os.path.join(workdir, "train_craft.npz"), state.craft_params)
    _save(os.path.join(workdir, "train_crnn.npz"), state.crnn_params)
    pages, maps = PageGenerator(seed=1).batch(4, 64, 64)
    crops, labels, label_lens, frame_lens = TextLineGenerator(seed=1).batch(4, width=64)
    np.savez(os.path.join(workdir, "batch.npz"), pages=pages, maps=maps, crops=crops, labels=labels,
             label_lens=label_lens, frame_lens=frame_lens)
    workers.spawn_ranks(workers.step_worker, WORLD, workdir, SPAWN_LIMIT_S)
    with open(os.path.join(workdir, "result.json")) as f:
        result = json.load(f)
    with np.load(os.path.join(workdir, "result.npz")) as data:
        samples = {k: data[k] for k in data.files}
    return result, samples


def test_sharded_joint_step_matches_unsharded(step_run):
    result, _ = step_run
    assert result["steps"] == [1, 1]
    for key in ("loss", "loss_det", "loss_rec"):
        got, want = result["sharded"][key], result["unsharded"][key]
        assert abs(got - want) <= 1e-5 * abs(want), key
    worst = {name: d for name, d in result["diffs"].items() if d[0] > 1e-5}
    assert not worst, worst
    # about half the parameters have step-1 gradients below 1e-6 at this
    # fresh initialisation; a few dozen more differ by over a tenth
    noisy = sum(d[2] for d in result["diffs"].values())
    assert noisy < 100, noisy


def test_sharded_joint_step_matches_jax_sharded_step(step_run):
    result, samples = step_run
    with open(os.path.join(DATA, "mesh_jax_f32.json")) as f:
        jax_run = json.load(f)
    with np.load(os.path.join(DATA, jax_run["samples_file"])) as data:
        recorded = {k: data[k] for k in data.files}
    for key in ("loss", "loss_det", "loss_rec"):
        assert abs(result["sharded"][key] - jax_run["step"][key]) <= 1e-5 * abs(jax_run["step"][key]), key
    noisy = 0
    for name, got in samples.items():
        want = recorded[f"{name}/value"]
        if name.startswith("params/"):
            mu_got, mu_want = samples["mu/" + name[7:]], recorded["mu/" + name[7:] + "/value"]
            skip, beyond_rule = workers.first_move_exempt(mu_got, mu_want)
            noisy += int(beyond_rule.sum())
            got, want = got[~skip], want[~skip]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    assert noisy < 5, noisy


@pytest.fixture
def one_rank_group():
    single_device_mesh("cpu")
    yield
    dist.destroy_process_group()


def test_one_rank_mesh_is_the_unsharded_path(one_rank_group):
    """``single_device_mesh("cpu")``: the engine reads a cover and the
    CRNN and joint steps step bit for bit as without a mesh."""
    from bbocr_tpu_torch.io import imread_gray
    from bbocr_tpu_torch.models import CRNN
    from bbocr_tpu_torch.runtime import OCREngine
    from bbocr_tpu_torch.train import TrainConfig, create_train_state, make_joint_train_step, make_optimizer
    from bbocr_tpu_torch.train.trainer import make_crnn_train_step, to_params
    from bbocr_tpu_torch.utils.checkpoint import load_params

    torch.set_num_threads(2)
    mesh = single_device_mesh("cpu")
    assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("dp", "tp")
    ckpt = os.path.join(os.path.dirname(DATA), "..", "checkpoints")
    craft, crnn = load_params(os.path.join(ckpt, "craft.npz")), load_params(os.path.join(ckpt, "crnn.npz"))
    cfg = workers.engine_config()
    image = imread_gray(os.path.join(workers.COVERS, "book2.png"))
    got = OCREngine(craft, crnn, cfg, device="cpu", mesh=mesh).readtext_batch([image, image[::-1]])
    want = OCREngine(craft, crnn, cfg, device="cpu").readtext_batch([image, image[::-1]])
    assert got and [[(q.tolist(), t, c) for q, t, c in r] for r in got] == \
        [[(q.tolist(), t, c) for q, t, c in r] for r in want]

    model = CRNN(num_classes=97)
    model.dtype = torch.float32
    params = to_params(model, crnn, "cpu")
    tx = make_optimizer(TrainConfig())
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy(rng.integers(0, 255, (4, 32, 64)).astype(np.uint8)),
             torch.from_numpy(rng.integers(1, 90, (4, 6)).astype(np.int32)), torch.tensor([6, 5, 4, 3]),
             torch.tensor([15, 15, 15, 15]))
    runs = [make_crnn_train_step(model, tx, mesh=m)(params, tx.init(params), *batch) for m in (mesh, None)]
    for a, b in zip(*(optim_leaves(r) for r in runs)):
        assert torch.equal(a, b)

    state, craft_m, crnn_m, tx = create_train_state(dtype=torch.float32, device="cpu")
    pages = torch.from_numpy(rng.integers(0, 255, (2, 64, 64)).astype(np.uint8))
    joint = {"pages": pages, "maps": torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 2)).astype(np.float32)),
             "crops": batch[0][:2], "labels": batch[1][:2], "label_lens": batch[2][:2], "frame_lens": batch[3][:2]}
    runs = [make_joint_train_step(craft_m, crnn_m, tx, mesh=m, state_example=state)(state, joint) for m in (mesh, None)]
    for a, b in zip(*(optim_leaves(r) for r in runs)):
        assert torch.equal(a, b)


def optim_leaves(tree) -> list:
    from bbocr_tpu_torch.train.optim import tree_leaves

    return [leaf for leaf in tree_leaves(tree) if torch.is_tensor(leaf)]
