"""The port's training slice against the JAX package's, on the CPU.

- optax's pieces (schedules, ``clip_by_global_norm``, ``adamw``) against
  ``train/optim.py`` over 5 steps on a small tree, both started from the
  same optax state (converted), float32 within 1e-6 relative;
- CTC against ``optax.ctc_loss``: values within 1e-5 relative and
  gradients within 1e-5 on feasible sequences, with frame and label
  paddings and a repeated label; a label too long for its frames gives
  optax's finite, large loss (its gradients there within 1e-2: the
  log-space sums sit near 1e5, where float32's spacing is 0.0078, and a
  gradient is the exponential of a difference of two of them);
- the four losses and their gradients against JAX float32: the CRNN
  (``checkpoints/crnn.npz``) on 4 crops of width 64, ``CRAFT`` and
  ``CRAFTLite`` (shipped checkpoints) on 2 pages of 64x64, a small seeded
  ``PageReader`` (``vlm_loss``, ``vlm_ctc_aux_loss``);
- two steps of each step maker from the same state in both packages, and
  the joint step as ``tests/test_runtime.py::TestTraining`` runs it;
- the initialisers' trees equal flax's in keys, shapes and dtypes, with
  ``w_hh`` orthogonal;
- the inverse bridge round trips exactly; ``save_params`` files load in
  JAX's ``load_params`` and the reverse; ``train_ckpt`` saves, finds the
  latest and restores.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bbocr_tpu.models import CRAFT as JaxCRAFT
from bbocr_tpu.models import CRAFTLite as JaxCRAFTLite
from bbocr_tpu.models import CRNN as JaxCRNN
from bbocr_tpu.models.vlm import PageReader as JaxPageReader
from bbocr_tpu.train import trainer as jax_trainer
from bbocr_tpu.utils import checkpoint as jax_checkpoint
from bbocr_tpu_torch.models import CRAFT, CRAFTLite, CRNN, PageReader
from bbocr_tpu_torch.models import convert
from bbocr_tpu_torch.models import init as port_init
from bbocr_tpu_torch.train import optim, trainer
from bbocr_tpu_torch.train.ctc import ctc_loss
from bbocr_tpu_torch.utils import checkpoint, train_ckpt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints")
SMALL_VLM = {"dim": 32, "enc_depth": 1, "dec_depth": 1, "heads": 2}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), tree)


def _assert_trees_close(got, want, rtol, atol=0.0):
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_got.keys() == flat_want.keys()
    for path, w in flat_want.items():
        np.testing.assert_allclose(np.asarray(flat_got[path]), np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _gradient_errors(got, want) -> tuple:
    """(max |got - want| over the tree's largest |want|, the worst leaf's
    max |got - want| over its own largest |want|, among leaves whose largest
    |want| reaches 1e-4 of the tree's: smaller ones, such as attention's key
    biases, whose gradient is zero but for rounding, are left to the first)."""
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_got.keys() == flat_want.keys()
    scale = max(float(np.abs(np.asarray(w)).max()) for w in flat_want.values())
    diffs = {k: float(np.abs(np.asarray(flat_got[k]) - np.asarray(w)).max()) for k, w in flat_want.items()}
    per_leaf = [diffs[k] / float(np.abs(np.asarray(w)).max()) for k, w in flat_want.items()
                if np.abs(np.asarray(w)).max() >= 1e-4 * scale]
    return max(diffs.values()) / scale, max(per_leaf)


# ---------------------------------------------------------------------------
# optax's pieces
# ---------------------------------------------------------------------------

CONFIGS = [
    jax_trainer.TrainConfig(),
    jax_trainer.TrainConfig(warmup_steps=3),
    jax_trainer.TrainConfig(schedule="cosine", warmup_steps=2, total_steps=6),
    jax_trainer.TrainConfig(schedule="cosine", total_steps=4, learning_rate=3e-3, weight_decay=1e-2),
]


def _port_config(cfg):
    return trainer.TrainConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


@pytest.mark.parametrize("cfg", CONFIGS, ids=["constant", "warmup", "cosine", "cosine_no_warmup"])
def test_schedules_match_optax(cfg):
    want = jax_trainer.make_schedule(cfg)
    got = trainer.make_schedule(_port_config(cfg))
    for count in range(12):
        w = float(want(jnp.asarray(count, jnp.int32))) if callable(want) else want
        g = float(got(torch.tensor(count, dtype=torch.int32))) if callable(got) else got
        assert g == pytest.approx(w, rel=1e-6, abs=1e-12), count


def _small_tree(rng):
    return {"a": {"kernel": rng.normal(size=(3, 4)).astype(np.float32)}, "b": rng.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize("cfg", CONFIGS, ids=["constant", "warmup", "cosine", "cosine_no_warmup"])
def test_adamw_and_clip_match_optax_from_converted_state(cfg):
    """Two optax steps, then the state converted to the port's and 5 more
    steps in each; the gradients' norms straddle the clip (5.0)."""
    rng = np.random.default_rng(0)
    params = _small_tree(rng)
    grads = [jax.tree_util.tree_map(lambda v, s=scale: (rng.normal(size=v.shape) * s).astype(np.float32), params)
             for scale in (0.1, 10.0, 0.5, 8.0, 0.01, 3.0, 20.0)]
    tx = jax_trainer.make_optimizer(cfg)
    p, state = jax.tree_util.tree_map(jnp.asarray, params), tx.init(params)
    for g in grads[:2]:
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
    port_tx = trainer.make_optimizer(_port_config(cfg))
    to_torch = lambda tree: jax.tree_util.tree_map(lambda v: torch.tensor(np.asarray(v)), tree)  # noqa: E731
    pp = to_torch(_np_tree(p))
    pstate = optim.from_optax(state, port_tx.init(pp), to_torch=lambda tree: _np_tree(tree))
    # the converted state goes back to optax's leaves unchanged
    back = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(state),
                                        jax.tree_util.tree_leaves(optim.to_optax(pstate)))
    _assert_trees_close(back, state, rtol=0)
    for g in grads[2:]:
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
        pupdates, pstate = port_tx.update(to_torch(g), pstate, pp)
        pp = optim.apply_updates(pp, pupdates)
    _assert_trees_close(optim.tree_map(lambda t: t.numpy(), pp), _np_tree(p), rtol=1e-6, atol=1e-9)
    got_state = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(state),
                                             jax.tree_util.tree_leaves(optim.to_optax(pstate)))
    _assert_trees_close(got_state, state, rtol=1e-5, atol=1e-12)


def test_clip_uses_optax_rule():
    rng = np.random.default_rng(1)
    for scale in (0.1, 100.0):
        g = {"w": (rng.normal(size=(7, 3)) * scale).astype(np.float32)}
        want, _ = optax.clip_by_global_norm(5.0).update(g, optax.EmptyState())
        got, _ = optim.clip_by_global_norm(5.0).update({"w": torch.tensor(g["w"])}, optim.EmptyState())
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------


def _ctc_case(seed, b=5, t=14, k=9, n=6):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(b, t, k)) * 3).astype(np.float32)
    labels = rng.integers(1, k, size=(b, n)).astype(np.int32)
    labels[0, 1] = labels[0, 0]  # a repeated label needs a blank between
    label_lens = np.array([3, n, 0, n, 2])[:b]
    frame_lens = np.array([t, t - 3, 5, 4, t])[:b]  # row 3: 6 labels in 4 frames
    label_pad = (np.arange(n)[None] >= label_lens[:, None]).astype(np.float32)
    labels = labels * (1 - label_pad.astype(np.int32))
    frame_pad = (np.arange(t)[None] >= frame_lens[:, None]).astype(np.float32)
    return logits, frame_pad, labels, label_pad


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_matches_optax(seed):
    logits, frame_pad, labels, label_pad = _ctc_case(seed)
    want = np.asarray(optax.ctc_loss(logits, frame_pad, labels, label_pad))
    weights = np.arange(1, logits.shape[0] + 1, dtype=np.float32)
    want_g = np.asarray(jax.grad(lambda x: (optax.ctc_loss(x, frame_pad, labels, label_pad) * weights).sum())(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = ctc_loss(x, torch.tensor(frame_pad), torch.tensor(labels), torch.tensor(label_pad))
    (got * torch.tensor(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    assert 1e5 < want[3] < 2e5  # the infeasible row: finite, large, as optax gives it
    feasible = [0, 1, 2, 4]
    np.testing.assert_allclose(x.grad.numpy()[feasible], want_g[feasible], atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy()[3], want_g[3], atol=1e-2 * weights[3])
    # F.ctc_loss, which the port does not use, has no finite answer there
    f = torch.nn.functional.ctc_loss(torch.log_softmax(torch.tensor(logits), -1).transpose(0, 1),
                                     torch.tensor(labels).long(), torch.tensor([14, 11, 5, 4, 14]),
                                     torch.tensor([3, 6, 0, 6, 2]), reduction="none")
    assert torch.isinf(f[3])


# ---------------------------------------------------------------------------
# Losses and gradients against JAX float32
# ---------------------------------------------------------------------------


def _crnn_batch(seed=0, b=4, w=64):
    rng = np.random.default_rng(seed)
    crops = rng.integers(0, 256, (b, 32, w)).astype(np.uint8)
    labels = rng.integers(1, 97, (b, 6)).astype(np.int32)
    label_lens = np.array([3, 6, 1, 4])[:b].astype(np.int32)
    frame_lens = np.array([w // 4 - 1, w // 4 - 1, 10, w // 4 - 1])[:b].astype(np.int32)
    labels = labels * (np.arange(6)[None] < label_lens[:, None])
    return crops, labels, label_lens, frame_lens


def _craft_batch(seed=0, b=2, size=64):
    rng = np.random.default_rng(seed)
    pages = rng.integers(0, 256, (b, size, size)).astype(np.uint8)
    maps = np.zeros((b, size // 2, size // 2, 2), np.float32)
    maps[:, 4:12, 6:20] = rng.random((b, 8, 14, 2))
    return pages, np.round(maps * 255).astype(np.uint8)


def _vlm_batch(seed=0, b=2, h=32, w=24):
    rng = np.random.default_rng(seed)
    pages = rng.integers(0, 256, (b, h, w)).astype(np.uint8)
    tokens = np.zeros((b, 10), np.int32)
    tok_lens = np.array([10, 6])[:b].astype(np.int32)
    for i, n in enumerate(tok_lens):
        tokens[i, :n] = np.concatenate([[97], rng.integers(1, 96, n - 2), [98]])
    char_labels = rng.integers(1, 96, (b, 5)).astype(np.int32)
    char_lens = np.array([5, 2])[:b].astype(np.int32)
    char_labels = char_labels * (np.arange(5)[None] < char_lens[:, None])
    return pages, tokens, tok_lens, char_labels, char_lens


@functools.lru_cache(maxsize=None)
def _small_vlm_variables():
    model = JaxPageReader(dtype=jnp.float32, **SMALL_VLM)
    init = jax.jit(lambda key: model.init(key, jnp.zeros((1, 32, 24, 1)), jnp.zeros((1, 4), jnp.int32), with_ctc=True))
    return _np_tree(init(jax.random.PRNGKey(3)))


def _small_vlm_tree():
    return jax.tree_util.tree_map(np.copy, _small_vlm_variables())


def _loss_case(name):
    """(jax loss of params, port model, port loss of params, flax tree)."""
    if name == "crnn":
        batch = _crnn_batch()
        jm = JaxCRNN(num_classes=97, dtype=jnp.float32)
        model = CRNN(num_classes=97)
        return (lambda p: jax_trainer.crnn_loss(jm, p, *map(jnp.asarray, batch)), model,
                lambda p: trainer.crnn_loss(model, p, *map(torch.tensor, batch), dtype=torch.float32),
                checkpoint.load_params(os.path.join(CKPT, "crnn.npz")))
    if name in ("craft", "craft_lite"):
        batch = _craft_batch()
        lite = name == "craft_lite"
        jm = JaxCRAFTLite(dtype=jnp.float32) if lite else JaxCRAFT(dtype=jnp.float32)
        model = CRAFTLite() if lite else CRAFT()
        path = os.path.join(CKPT, "candidates", "craft_lite_raw.npz") if lite else os.path.join(CKPT, "craft.npz")
        return (lambda p: jax_trainer.craft_loss(jm, p, *map(jnp.asarray, batch)), model,
                lambda p: trainer.craft_loss(model, p, *map(torch.tensor, batch), dtype=torch.float32),
                checkpoint.load_params(path))
    batch = _vlm_batch()
    jm = JaxPageReader(dtype=jnp.float32, **SMALL_VLM)
    model = PageReader(dtype=torch.float32, **SMALL_VLM)
    jb, tb = tuple(map(jnp.asarray, batch)), tuple(map(torch.tensor, batch))
    if name == "vlm":
        return (lambda p: jax_trainer.vlm_loss(jm, p, *jb[:3]), model,
                lambda p: trainer.vlm_loss(model, p, *tb[:3]), _small_vlm_tree())
    return (lambda p: jax_trainer.vlm_ctc_aux_loss(jm, p, jb[0], *jb[3:]), model,
            lambda p: trainer.vlm_ctc_aux_loss(model, p, tb[0], *tb[3:]), _small_vlm_tree())


@pytest.mark.parametrize("name", ["crnn", "craft", "craft_lite", "vlm", "vlm_ctc"])
def test_losses_and_gradients_match_jax_float32(name):
    """Loss within 1e-5 relative; the gradients within 1e-4 of the tree's
    largest gradient, and each leaf within 5e-3 of its own largest (float32
    sums in another order; the deepest CRAFT leaves sum many small terms
    that cancel)."""
    jax_loss, model, port_loss, tree = _loss_case(name)
    want, want_g = jax.jit(jax.value_and_grad(jax_loss))(jax.tree_util.tree_map(jnp.asarray, tree))
    params = trainer.to_params(model, tree, "cpu")
    got, _, got_g = trainer.value_and_grad(port_loss, params)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    got_tree = trainer.to_tree(model, got_g)
    want_tree = _np_tree(want_g)
    if name == "vlm":  # the loss does not reach the CTC head: zero gradients in both
        assert not np.any(got_tree["params"]["ctc_head"]["kernel"])
    tree_err, leaf_err = _gradient_errors(got_tree, want_tree)
    assert tree_err < 1e-4 and leaf_err < 5e-3, (tree_err, leaf_err)


def test_add_on_a_product_backpropagates_as_a_sum():
    """``dot_xla_order``'s in-place block sums (``out.add_(a @ w)``) give
    the gradient of the plain product."""
    from bbocr_tpu_torch.models.layers import dot_xla_order

    rng = np.random.default_rng(2)
    a = torch.tensor(rng.normal(size=(8, 300)).astype(np.float32), requires_grad=True)
    w = torch.tensor(rng.normal(size=(300, 5)).astype(np.float32), requires_grad=True)
    up = torch.tensor(rng.normal(size=(8, 5)).astype(np.float32))
    (dot_xla_order(a, w) * up).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), up.numpy() @ w.detach().numpy().T, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), a.detach().numpy().T @ up.numpy(), rtol=1e-5, atol=1e-5)


def test_bfloat16_compute_keeps_float32_masters():
    """In bfloat16 the CRNN's loss follows JAX's bfloat16 loss (within 1e-2
    relative), its gradients reach the float32 parameters and stay
    float32, and the module's own parameters are untouched."""
    batch = _crnn_batch()
    tree = checkpoint.load_params(os.path.join(CKPT, "crnn.npz"))
    jm = JaxCRNN(num_classes=97, dtype=jnp.bfloat16)
    want = float(jax.jit(lambda p: jax_trainer.crnn_loss(jm, p, *map(jnp.asarray, batch)))(
        jax.tree_util.tree_map(jnp.asarray, tree)))
    model = CRNN(num_classes=97)
    params = trainer.to_params(model, tree, "cpu")
    loss, _, grads = trainer.value_and_grad(
        lambda p: trainer.crnn_loss(model, p, *map(torch.tensor, batch), dtype=torch.bfloat16), params)
    assert float(loss) == pytest.approx(want, rel=1e-2)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["crnn", "craft_lite", "vlm"])
def test_two_steps_match_jax_step_makers(name):
    """Two steps of each step maker from the same parameters and optimizer
    state (cosine schedule, warmup 1): losses within 1e-5 relative,
    parameters within 1e-5 absolute where the step-1 gradient reaches 1e-6."""
    cfg = jax_trainer.TrainConfig(schedule="cosine", warmup_steps=1, total_steps=4, learning_rate=1e-3)
    if name == "crnn":
        batch = _crnn_batch()
        jm, model = JaxCRNN(num_classes=97, dtype=jnp.float32), CRNN(num_classes=97)
        tree = checkpoint.load_params(os.path.join(CKPT, "crnn.npz"))
        jax_step = jax_trainer.make_crnn_train_step(jm, jax_trainer.make_optimizer(cfg))
        port_tx = trainer.make_optimizer(_port_config(cfg))
        port_step = trainer.make_crnn_train_step(model, port_tx, dtype=torch.float32)
        loss_fn = lambda p: trainer.crnn_loss(model, p, *map(torch.tensor, batch), dtype=torch.float32)  # noqa: E731
    elif name == "craft_lite":
        batch = _craft_batch()
        jm, model = JaxCRAFTLite(dtype=jnp.float32), CRAFTLite()
        tree = checkpoint.load_params(os.path.join(CKPT, "candidates", "craft_lite_raw.npz"))
        jax_step = jax_trainer.make_craft_train_step(jm, jax_trainer.make_optimizer(cfg))
        port_tx = trainer.make_optimizer(_port_config(cfg))
        port_step = trainer.make_craft_train_step(model, port_tx, dtype=torch.float32)
        loss_fn = lambda p: trainer.craft_loss(model, p, *map(torch.tensor, batch), dtype=torch.float32)  # noqa: E731
    else:
        batch = _vlm_batch()
        jm, model = JaxPageReader(dtype=jnp.float32, **SMALL_VLM), PageReader(dtype=torch.float32, **SMALL_VLM)
        tree = _small_vlm_tree()
        jax_step = jax_trainer.make_vlm_train_step(jm, jax_trainer.make_optimizer(cfg), ctc_weight=0.5)
        port_tx = trainer.make_optimizer(_port_config(cfg))
        port_step = trainer.make_vlm_train_step(model, port_tx, ctc_weight=0.5)
        tb = tuple(map(torch.tensor, batch))
        loss_fn = lambda p: (trainer.vlm_loss(model, p, *tb[:3])  # noqa: E731
                             + 0.5 * trainer.vlm_ctc_aux_loss(model, p, tb[0], *tb[3:]))
    jp = jax.tree_util.tree_map(jnp.array, tree)
    jstate = jax_trainer.make_optimizer(cfg).init(jp)
    params = trainer.to_params(model, tree, "cpu")
    state = port_tx.init(params)
    _, _, grads = trainer.value_and_grad(loss_fn, params)
    want_losses, got_losses = [], []
    for _ in range(2):
        jp, jstate, loss = jax_step(jp, jstate, *map(jnp.asarray, batch))
        want_losses.append(float(loss))
        params, state, loss = port_step(params, state, *map(torch.tensor, batch))
        got_losses.append(float(loss))
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    assert int(state[1][0].count) == 2 and int(state[1][2].count) == 2
    got, want = trainer.to_tree(model, params), _np_tree(jp)
    small = trainer.to_tree(model, optim.tree_map(lambda g: (g.abs() < 1e-6).float(), grads))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = np.asarray(dict(jax.tree_util.tree_leaves_with_path(got))[path])
        keep = np.asarray(dict(jax.tree_util.tree_leaves_with_path(small))[path]) == 0
        np.testing.assert_allclose(g[keep], np.asarray(w)[keep], atol=1e-5, err_msg=jax.tree_util.keystr(path))


def test_joint_step_runs_and_matches_jax_losses():
    """``tests/test_runtime.py::TestTraining::test_single_device_step_runs``
    on the port: fresh state, one joint step on synthetic pages and crops;
    the step's losses equal JAX's losses on the same parameters."""
    from bbocr_tpu.train.synth import PageGenerator, TextLineGenerator

    state, craft, crnn, tx = trainer.create_train_state(dtype=torch.float32, device="cpu")
    step = trainer.make_joint_train_step(craft, crnn, tx)
    pages, maps = PageGenerator(seed=0).batch(2, 64, 64)
    crops, labels, label_lens, frame_lens = TextLineGenerator(seed=0).batch(2, width=64)
    batch = {"pages": pages, "maps": maps, "crops": crops, "labels": labels, "label_lens": label_lens,
             "frame_lens": frame_lens}
    state2, metrics = step(state, {k: torch.tensor(v) for k, v in batch.items()})
    assert int(state2.step) == 1
    assert all(np.isfinite(float(metrics[k])) for k in ("loss", "loss_det", "loss_rec"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_det = jax.jit(lambda p: jax_trainer.craft_loss(JaxCRAFT(dtype=jnp.float32), p, jb["pages"], jb["maps"]))(
        trainer.to_tree(craft, state.craft_params))
    want_rec = jax_trainer.crnn_loss(JaxCRNN(num_classes=97, dtype=jnp.float32),
                                     trainer.to_tree(crnn, state.crnn_params), jb["crops"], jb["labels"],
                                     jb["label_lens"], jb["frame_lens"])
    assert float(metrics["loss_det"]) == pytest.approx(float(want_det), rel=1e-5)
    assert float(metrics["loss_rec"]) == pytest.approx(float(want_rec), rel=1e-5)
    # a mesh without the state example is refused as in JAX (tests/test_torch_parallel.py runs meshes)
    with pytest.raises(ValueError, match="state_example is required when sharding over a mesh"):
        trainer.make_joint_train_step(craft, crnn, tx, mesh=object())


# ---------------------------------------------------------------------------
# Initialisers, the inverse bridge, checkpoints
# ---------------------------------------------------------------------------


def _shapes(tree):
    return jax.tree_util.tree_map(lambda v: (tuple(np.shape(v)), str(np.asarray(v).dtype)), _leaves_only(tree))


def _flax_shapes(module, input_shape):
    """Keys, shapes and dtypes of ``module.init``'s tree, without running it."""
    tree = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(input_shape))
    return jax.tree_util.tree_map(lambda v: (tuple(v.shape), str(v.dtype)), jax.tree_util.tree_map(lambda v: v, dict(tree)))


def _leaves_only(tree):
    return {k: _leaves_only(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def test_initialisers_give_flax_trees():
    crnn = port_init.init_crnn(0, 97)
    assert _shapes(crnn) == _flax_shapes(JaxCRNN(num_classes=97), (1, 32, 64, 1))
    lite = port_init.init_craft(0, lite=True)
    assert _shapes(lite) == _flax_shapes(JaxCRAFTLite(), (1, 64, 64, 3))
    vlm = port_init.init_pagereader(0, with_ctc=True, heads=2, **{k: v for k, v in SMALL_VLM.items() if k != "heads"})
    assert _shapes(vlm) == _shapes(_small_vlm_tree())
    assert "ctc_head" not in port_init.init_pagereader(0, heads=2, dim=32, enc_depth=1, dec_depth=1)["params"]
    w_hh = crnn["params"]["rnn0"]["fwd"]["w_hh"]
    np.testing.assert_allclose(w_hh @ w_hh.T, np.eye(w_hh.shape[0]), atol=1e-5)  # orthonormal rows
    b = crnn["params"]["rnn0"]["fwd"]["b_ih"]
    assert np.all(b[256:512] == 1) and not np.any(b[:256]) and not np.any(b[512:])
    k = crnn["params"]["VGGFeatures_0"]["Conv_3"]["kernel"]  # lecun_normal: variance 1 / fan_in
    assert k.shape == (3, 3, 128, 128)
    assert np.abs(k).max() <= 2 * np.sqrt(1 / (9 * 128)) / 0.87962566103423978 + 1e-7
    assert np.std(k) == pytest.approx(np.sqrt(1 / (9 * 128)), rel=0.05)
    assert np.all(crnn["params"]["VGGFeatures_0"]["GroupNorm_0"]["scale"] == 1)
    emb = vlm["params"]["tok_embed"]["embedding"]
    assert np.std(emb) == pytest.approx(np.sqrt(1 / 32), rel=0.1)


def test_create_train_state_and_engine_create():
    from bbocr_tpu_torch.runtime import EngineConfig, OCREngine

    state, craft, crnn, tx = trainer.create_train_state(seed=1, device="cpu")
    assert craft.dtype == crnn.dtype == torch.bfloat16
    assert _shapes(trainer.to_tree(craft, state.craft_params)) == _flax_shapes(JaxCRAFT(), (1, 64, 64, 3))
    again, _, _, _ = trainer.create_train_state(seed=1, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(state.crnn_params.values(), again.crnn_params.values()))
    engine = OCREngine.create(seed=1, config=EngineConfig(compute_dtype=torch.float32), device="cpu")
    sd = engine.crnn.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in state.crnn_params.items())
    # create(mesh=) builds the mesh engine: on a 1x1 mesh, the same parameters
    import torch.distributed as dist

    from bbocr_tpu_torch.parallel.mesh import single_device_mesh

    mesh = single_device_mesh("cpu")
    try:
        meshed = OCREngine.create(seed=1, config=EngineConfig(compute_dtype=torch.float32), mesh=mesh, device="cpu")
        assert meshed.mesh is mesh and meshed.device == torch.device("cpu")
        assert all(torch.equal(meshed.crnn.state_dict()[k], v) for k, v in sd.items())
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("path", ["craft.npz", "candidates/craft_lite_raw.npz", "crnn.npz", "vlm.npz", "small_vlm"])
def test_inverse_bridge_round_trips_and_checkpoints_load_both_ways(path, tmp_path):
    if path == "small_vlm":
        tree = _small_vlm_tree()
        back = convert.pagereader_params(convert.pagereader_state_dict(tree), heads=2)
    else:
        tree = checkpoint.load_params(os.path.join(CKPT, path))
        kind = os.path.basename(path).split("_")[0].split(".")[0]
        to_sd, to_tree = {"craft": (convert.craft_state_dict, convert.craft_params),
                          "crnn": (convert.crnn_state_dict, convert.crnn_params),
                          "vlm": (convert.pagereader_state_dict, convert.pagereader_params)}[kind]
        back = to_tree(to_sd(tree))
    _assert_trees_close(back, tree, rtol=0)
    if path in ("craft.npz", "vlm.npz"):  # compressing 20M parameters takes long: files of the smaller trees
        return
    # the port's file in JAX's loader, and JAX's file in the port's
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    checkpoint.save_params(ours, back)
    _assert_trees_close(jax_checkpoint.load_params(ours), tree, rtol=0)
    jax_checkpoint.save_params(theirs, jax.tree_util.tree_map(jnp.asarray, tree))
    _assert_trees_close(checkpoint.load_params(theirs), tree, rtol=0)


def test_train_ckpt_save_latest_restore(tmp_path):
    state, craft, crnn, tx = trainer.create_train_state(device="cpu", config=trainer.TrainConfig(
        schedule="cosine", total_steps=5))
    example = {"step": 0, "params": state.crnn_params, "opt_state": tx.init(state.crnn_params)}
    assert train_ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    for step in (2, 10, 3):
        saved = dict(example, step=step)
        train_ckpt.save_train_state(str(tmp_path), saved, step=step)
    train_ckpt.save_train_state(str(tmp_path), example)
    latest = train_ckpt.latest_checkpoint(str(tmp_path))
    assert os.path.basename(latest) == "step_10"
    zeroed = {"step": 0, "params": optim.tree_map(torch.zeros_like, example["params"]),
              "opt_state": tx.init(optim.tree_map(torch.zeros_like, example["params"]))}
    back = train_ckpt.restore_train_state(latest, zeroed)
    assert back["step"] == 10
    assert all(torch.equal(back["params"][k], v) for k, v in example["params"].items())
    assert type(back["opt_state"][1][0]).__name__ == "ScaleByAdamState"
    assert back["opt_state"][1][0].count.dtype == torch.int32
