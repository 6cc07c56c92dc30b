"""Training: losses, optimizer state and the train steps, in PyTorch.

Counterpart of ``bbocr_tpu/train/trainer.py``. Parameters are dicts of
float32 tensors keyed as the port module's state dict (``to_params`` and
``to_tree`` convert to and from the flax tree that checkpoints hold); the
optimizer is optax's, written out in ``train/optim.py``; CTC is optax's
recursion (``train/ctc.py``).

Precision follows flax: the parameters stay float32 and every forward casts
them to the compute type (``dtype``, bfloat16 by default as flax's modules
default; the normalisations' scales and biases stay float32), so the
gradients flow back through the cast into float32 (``cast_params`` and
``torch.func.functional_call``). The inference path (``cast_for_compute``,
which casts a module once) is not used here. The forwards are the port's
inference forwards: the CRNN's products in XLA's block order, its LSTM's
per-step scan and CRAFT's layers, differentiated by autograd.

The step makers return plain functions ``(params, opt_state, *batch) ->
(params, opt_state, loss)`` (the joint step ``(state, batch) -> (state,
metrics)``), as the JAX ones return jitted programs.

With a ``mesh`` (``parallel/mesh.py``) a step runs SPMD: every rank calls
it with the same whole batch and state and takes its dp block of the
batch. The losses normalise over the global batch as GSPMD's do (the
counts they divide by are all-reduced over dp first, each rank's partial
sums divided by them), the partial losses and the gradients are summed over
dp, and every rank returns the same whole state and metrics. The joint
step also splits the widest weights over tp (``param_shardings``) and
Adam's moments with them (``_shard_opt_like``): each rank computes with
its slices, clips by the norm that counts every slice once over the tp
group, updates its slices elementwise, and gathers them whole again.

No TPU kernel lies on this path: the JAX trainer reaches no Pallas call,
and what XLA compiles there (losses, CTC, optimizer, backward passes) is
plain PyTorch here.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from bbocr_tpu_torch.models import CRAFT, CRNN, EN_CHARSET
from bbocr_tpu_torch.models.convert import (
    craft_params,
    craft_state_dict,
    crnn_params,
    crnn_state_dict,
    pagereader_params,
    pagereader_state_dict,
)
from bbocr_tpu_torch.models.craft import IMAGENET_MEAN, IMAGENET_STD, CRAFTLite
from bbocr_tpu_torch.models.layers import BatchNorm
from bbocr_tpu_torch.parallel.sharding import (
    param_shardings,
    replicate_sharding,
    shard_tree,
    tp_layers,
    tree_map_with_path,
    unshard_tree,
)
from bbocr_tpu_torch.train import optim
from bbocr_tpu_torch.train.ctc import ctc_loss


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    grad_clip: float = 5.0
    # Online hard-negative balance for detector MSE (text pixels are sparse).
    detector_neg_ratio: float = 3.0
    # LR schedule: "constant" or "cosine" (linear warmup -> cosine decay to
    # learning_rate * final_lr_frac over total_steps).
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0
    final_lr_frac: float = 0.05


class TrainState(NamedTuple):
    step: torch.Tensor
    craft_params: Any
    crnn_params: Any
    opt_state: Any


def make_schedule(config: TrainConfig):
    """LR schedule per config: constant, warmup-only, or warmup+cosine."""
    if config.schedule == "cosine":
        if config.total_steps <= 0:
            raise ValueError("cosine schedule requires total_steps > 0")
        return optim.warmup_cosine_decay_schedule(
            init_value=0.0 if config.warmup_steps > 0 else config.learning_rate,
            peak_value=config.learning_rate,
            warmup_steps=max(config.warmup_steps, 1),
            decay_steps=config.total_steps,
            end_value=config.learning_rate * config.final_lr_frac,
        )
    if config.warmup_steps > 0:
        return optim.linear_schedule(
            init_value=0.0,
            end_value=config.learning_rate,
            transition_steps=config.warmup_steps,
        )
    return config.learning_rate


def make_optimizer(config: TrainConfig) -> optim.GradientTransformation:
    return optim.chain(
        optim.clip_by_global_norm(config.grad_clip),
        optim.adamw(make_schedule(config), weight_decay=config.weight_decay),
    )


# ---------------------------------------------------------------------------
# Parameters: flax trees <-> dicts of tensors; the per-call cast
# ---------------------------------------------------------------------------


def to_params(model: nn.Module, tree: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """A flax tree (``{"params": ...}``) -> float32 tensors on ``device``
    keyed as ``model``'s state dict (``CRAFT``/``CRAFTLite`` with the RGB
    stem, ``CRNN``, ``PageReader``)."""
    if type(model).__name__ == "PageReader":
        sd = pagereader_state_dict(tree)
    elif isinstance(model, CRNN):
        sd = crnn_state_dict(tree)
    else:
        sd = craft_state_dict(tree)
    return {k: v.to(device=device, dtype=torch.float32).clone() for k, v in sd.items()}


def to_tree(model: nn.Module, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``to_params``: numpy float32 leaves in flax's tree."""
    if type(model).__name__ == "PageReader":
        return pagereader_params(params, heads=model.blocks[0].attns[0].heads, patch=model.encoder.patch)
    if isinstance(model, CRNN):
        return crnn_params(params)
    return craft_params(params)


def _norm_names(model: nn.Module) -> set:
    names = set()
    for prefix, module in model.named_modules():
        if isinstance(module, (nn.GroupNorm, BatchNorm)):
            names.update(f"{prefix}.{n}" for n, _ in module.named_parameters(recurse=False))
    return names


def cast_params(model: nn.Module, params: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``params`` cast to ``dtype`` for one forward, the normalisations'
    scales and biases kept float32, as flax's ``param_dtype``; the cast is
    differentiable, so gradients reach the float32 masters."""
    if dtype == torch.float32:
        return params
    keep = _norm_names(model)
    return {k: v if k in keep else v.to(dtype) for k, v in params.items()}


def _dtype(model: nn.Module, dtype: Optional[torch.dtype]) -> torch.dtype:
    """The compute type: the one given, else the model's ``dtype``
    attribute (the PageReader's, or the one ``create_train_state`` set),
    else bfloat16, flax's modules' default."""
    return dtype if dtype is not None else getattr(model, "dtype", torch.bfloat16)


class _Method(nn.Module):
    """Calls ``model.<name>`` so that ``functional_call`` can run a method
    other than ``forward`` (the PageReader's ``encode_ctc``)."""

    def __init__(self, model: nn.Module, name: str):
        super().__init__()
        self.model, self.name = model, name

    def forward(self, *args):
        return getattr(self.model, self.name)(*args)


def apply(model: nn.Module, params, *args, dtype=None, method: str = "forward"):
    """``model.<method>(*args)`` computed with ``params``: the float32
    parameters cast to the compute type per call (``cast_params``; the
    PageReader casts inside its layers, so it takes them as they are)."""
    if type(model).__name__ != "PageReader":
        params = cast_params(model, params, _dtype(model, dtype))
    if method == "forward":
        return torch.func.functional_call(model, params, args)
    return torch.func.functional_call(_Method(model, method), {f"model.{k}": v for k, v in params.items()}, args)


def craft_maps(craft: nn.Module, params, pages, dtype=None) -> torch.Tensor:
    """(B, H, W) gray pages in [0,255] -> (B, H/2, W/2, 2) float32 score
    maps: gray repeated to RGB, /255, ImageNet-normalised, as the JAX
    trainer feeds CRAFT."""
    rgb01 = pages.float()[:, None].expand(-1, 3, -1, -1) / _const(255.0, pages)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=pages.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=pages.device)[:, None, None]
    x = ((rgb01 - mean) / std).to(_dtype(craft, dtype))
    return apply(craft, params, x, dtype=dtype).permute(0, 2, 3, 1)


def crnn_logits(crnn: CRNN, params, crops, dtype=None) -> torch.Tensor:
    """(B, 32, W) crops in [0,255] -> (B, T, C) float32 logits."""
    x = (crops.float() / _const(127.5, crops) - 1.0)[:, None]
    return apply(crnn, params, x.to(_dtype(crnn, dtype)), dtype=dtype)


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    # a tensor operand: CUDA divides by a Python number through its reciprocal
    return torch.tensor(value, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _batch_mean(x: torch.Tensor, total) -> torch.Tensor:
    """The mean over the batch, or, with ``total`` (a rank's counts -> the
    global ones), this rank's part of the global batch's mean."""
    if total is None:
        return torch.mean(x)
    return x.sum() / total(torch.tensor(float(x.shape[0]), device=x.device))


def crnn_loss(crnn: CRNN, params, crops, labels, label_lens, frame_lens, dtype=None, total=None) -> torch.Tensor:
    """CTC loss on (B, 32, W) crops in [0,255] (any dtype; u8 on the wire),
    each sequence's loss divided by its label length, averaged. Every loss
    takes ``total``: under a mesh, the function from a rank's counts to the
    global batch's, so that the rank computes its part of the global loss."""
    logits = crnn_logits(crnn, params, crops, dtype)  # (B, T, C)
    _, t, _ = logits.shape
    frame_idx = torch.arange(t, device=logits.device)[None, :]
    logit_pad = (frame_idx >= frame_lens[:, None]).float()
    label_idx = torch.arange(labels.shape[1], device=logits.device)[None, :]
    label_pad = (label_idx >= label_lens[:, None]).float()
    per_seq = ctc_loss(logits, logit_pad, labels, label_pad)
    norm = torch.clamp(label_lens.float(), min=1.0)
    return _batch_mean(per_seq / norm, total)


def craft_loss(craft: nn.Module, params, pages, target_maps, neg_ratio: float = 3.0, dtype=None,
               total=None) -> torch.Tensor:
    """Balanced MSE on region/affinity heatmaps.

    ``pages``: (B, H, W) gray [0,255]; targets (B, H/2, W/2, 2) in [0,1], or
    uint8 quantised (dequantised by /255).
    """
    if target_maps.dtype == torch.uint8:
        target_maps = target_maps.float() / _const(255.0, target_maps)
    else:
        target_maps = target_maps.float()
    pred = craft_maps(craft, params, pages, dtype)
    err = (pred - target_maps) ** 2
    total = total or (lambda count: count)
    pos = (target_maps > 0.1).float()
    n_pos = torch.clamp(total(pos.sum()), min=1.0)
    pos_loss = (err * pos).sum() / n_pos
    neg = 1.0 - pos
    n_neg = torch.clamp(total(neg.sum()), min=1.0)
    neg_loss = (err * neg).sum() / n_neg
    return pos_loss + neg_ratio * neg_loss


def vlm_loss(model: nn.Module, params, pages, tokens, tok_lens, total=None) -> torch.Tensor:
    """Next-token cross-entropy of the PageReader, PAD positions masked.

    ``pages`` (B, H, W) gray in [0,255]; ``tokens`` (B, L) padded BOS..EOS.
    The model computes in its ``dtype`` over the float32 ``params``.
    """
    tokens = tokens.long()
    logits = apply(model, params, pages.float()[..., None], tokens[:, :-1])
    targets = tokens[:, 1:]
    steps = torch.arange(targets.shape[1], device=tokens.device)[None, :]
    mask = (steps < (tok_lens - 1)[:, None]).float()
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    count = mask.sum() if total is None else total(mask.sum())
    return (nll * mask).sum() / torch.clamp(count, min=1.0)


def vlm_ctc_aux_loss(model: nn.Module, params, pages, char_labels, char_lens, total=None) -> torch.Tensor:
    """CTC over the row-major encoder token grid against the page's
    transcription (``PageReader.encode_ctc``): every grid token is a frame."""
    _, ctc_logits = apply(model, params, pages.float()[..., None], method="encode_ctc")
    b, t, _ = ctc_logits.shape
    logit_pad = torch.zeros((b, t), dtype=torch.float32, device=ctc_logits.device)
    label_idx = torch.arange(char_labels.shape[1], device=ctc_logits.device)[None, :]
    label_pad = (label_idx >= char_lens[:, None]).float()
    per_seq = ctc_loss(ctc_logits, logit_pad, char_labels, label_pad)
    return _batch_mean(per_seq / torch.clamp(char_lens.float(), min=1.0), total)


# ---------------------------------------------------------------------------
# State and steps
# ---------------------------------------------------------------------------


def create_train_state(
    seed: int = 0,
    config: TrainConfig = TrainConfig(),
    charset=EN_CHARSET,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
) -> Tuple[TrainState, CRAFT, CRNN, optim.GradientTransformation]:
    """Fresh parameters (``models/init.py``, one ``torch.Generator`` seeded
    with ``seed``), the optimizer and its state. The returned modules carry
    ``dtype`` as their compute type."""
    from bbocr_tpu_torch.models.init import init_engine_params

    craft_tree, crnn_tree = init_engine_params(seed, charset.num_classes)
    craft, crnn = CRAFT().to(device), CRNN(num_classes=charset.num_classes).to(device)
    craft.dtype = crnn.dtype = dtype
    craft_p, crnn_p = to_params(craft, craft_tree, device), to_params(crnn, crnn_tree, device)
    tx = make_optimizer(config)
    opt_state = tx.init((craft_p, crnn_p))
    state = TrainState(torch.zeros((), dtype=torch.int32, device=device), craft_p, crnn_p, opt_state)
    return state, craft, crnn, tx


def value_and_grad(loss_fn, params) -> Tuple[torch.Tensor, Any, Any]:
    """(loss, aux, grads) of ``loss_fn(params) -> loss or (loss, aux)``;
    a parameter the loss does not reach gets a zero gradient, as in JAX."""
    leaves = optim.tree_map(lambda v: v.detach().requires_grad_(True), params)
    flat = optim.tree_leaves(leaves)
    with torch.enable_grad():
        out = loss_fn(leaves)
        loss, aux = out if isinstance(out, tuple) else (out, None)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = iter([torch.zeros_like(v) if g is None else g for v, g in zip(flat, grads)])
    return loss.detach(), aux, optim.tree_map(lambda _: next(grads), params)


def _update(tx, grads, opt_state, params):
    updates, new_opt = tx.update(grads, opt_state, params)
    return optim.apply_updates(params, updates), new_opt


class _MeshStep:
    """A train step's collectives over a mesh's dp group: this rank's
    contiguous block of each batch array, the losses' global counts, and
    sums over dp."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.dp = mesh.size(0)
        self.rank = mesh.get_local_rank("dp")
        self.group = mesh.get_group("dp")

    def block(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if n % self.dp:
            raise ValueError(f"a batch of {n} does not split evenly over dp={self.dp}")
        k = n // self.dp
        return x[self.rank * k : (self.rank + 1) * k]

    @property
    def total(self):
        """The losses' ``total``: None at dp = 1, where the local counts are
        the global ones and the loss is the unsharded one."""
        return self._total if self.dp > 1 else None

    def _total(self, count: torch.Tensor) -> torch.Tensor:
        count = count.detach().clone()
        dist.all_reduce(count, group=self.group)
        return count

    def sum(self, tree):
        """Every leaf (float32) summed over dp, in one all-reduce."""
        leaves = optim.tree_leaves(tree)
        flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
        dist.all_reduce(flat, group=self.group)
        parts = iter(torch.split(flat, [leaf.numel() for leaf in leaves]))
        return optim.tree_map(lambda leaf: next(parts).view_as(leaf), tree)


def _dp_step(mesh, loss_fn):
    """``(params, batch arrays) -> (loss, grads)`` of ``loss_fn(params,
    arrays, total)``: on the whole batch without a mesh; under one, on this
    rank's dp block with the global counts, loss and gradients summed over
    dp."""
    view = _MeshStep(mesh) if mesh is not None else None

    def run(params, arrays):
        if view is None:
            loss, _, grads = value_and_grad(lambda p: loss_fn(p, arrays, None), params)
            return loss, grads
        arrays = [view.block(a) for a in arrays]
        loss, _, grads = value_and_grad(lambda p: loss_fn(p, arrays, view.total), params)
        return view.sum((loss, grads))

    return run


def make_crnn_train_step(crnn: CRNN, tx: optim.GradientTransformation, mesh: Any = None, dtype=None):
    """(params, opt_state, crops, labels, label_lens, frame_lens) ->
    (params, opt_state, loss) for the recognizer alone; with a ``mesh`` the
    batch splits over dp and the parameters stay whole on every rank."""
    run = _dp_step(mesh, lambda p, b, total: crnn_loss(crnn, p, *b, dtype, total=total))

    def step(params, opt_state, crops, labels, label_lens, frame_lens):
        loss, grads = run(params, (crops, labels, label_lens, frame_lens))
        return (*_update(tx, grads, opt_state, params), loss)

    return step


def make_craft_train_step(
    craft: nn.Module, tx: optim.GradientTransformation, mesh: Any = None, neg_ratio: float = 3.0, dtype=None,
):
    """(params, opt_state, pages, maps) -> (params, opt_state, loss); with a
    ``mesh`` as ``make_crnn_train_step``."""
    run = _dp_step(mesh, lambda p, b, total: craft_loss(craft, p, *b, neg_ratio, dtype, total=total))

    def step(params, opt_state, pages, maps):
        loss, grads = run(params, (pages, maps))
        return (*_update(tx, grads, opt_state, params), loss)

    return step


def make_vlm_train_step(model: nn.Module, tx: optim.GradientTransformation, mesh: Any = None, ctc_weight: float = 0.0):
    """(params, opt_state, pages, tokens, tok_lens[, char_labels, char_lens])
    -> (params, opt_state, loss); ``ctc_weight`` > 0 adds the encoder CTC
    auxiliary loss, and the step then takes the two character arrays. With
    a ``mesh`` as ``make_crnn_train_step``."""

    def loss_fn(p, b, total):
        pages, tokens, tok_lens, *ctc_batch = b
        ce = vlm_loss(model, p, pages, tokens, tok_lens, total=total)
        if ctc_weight > 0.0:
            ce = ce + ctc_weight * vlm_ctc_aux_loss(model, p, pages, *ctc_batch, total=total)
        return ce

    run = _dp_step(mesh, loss_fn)

    def step(params, opt_state, pages, tokens, tok_lens, *ctc_batch):
        loss, grads = run(params, (pages, tokens, tok_lens, *ctc_batch))
        return (*_update(tx, grads, opt_state, params), loss)

    return step


def make_joint_train_step(
    craft: nn.Module,
    crnn: CRNN,
    tx: optim.GradientTransformation,
    mesh: Any = None,
    config: TrainConfig = TrainConfig(),
    state_example: Optional[TrainState] = None,
    dtype=None,
):
    """(state, batch) -> (state, metrics): both models under one optimizer.

    ``batch``: dict with pages (B,H,W), maps (B,H/2,W/2,2), crops (B2,32,W2),
    labels (B2,L), label_lens (B2,), frame_lens (B2,).

    With a mesh, pass ``state_example`` (for the shardings): the batch
    splits over dp, the widest weights and their Adam moments over tp.
    """

    def loss_fn(both, batch, total):
        cp, rp = both
        l_det = craft_loss(craft, cp, batch["pages"], batch["maps"], config.detector_neg_ratio, dtype, total=total)
        l_rec = crnn_loss(
            crnn, rp, batch["crops"], batch["labels"], batch["label_lens"], batch["frame_lens"], dtype, total=total
        )
        return l_det + l_rec, {"loss_det": l_det.detach(), "loss_rec": l_rec.detach()}

    if mesh is None:
        def step(state: TrainState, batch: Dict[str, torch.Tensor]):
            both = (state.craft_params, state.crnn_params)
            loss, metrics, grads = value_and_grad(lambda p: loss_fn(p, batch, None), both)
            (new_craft, new_crnn), new_opt = _update(tx, grads, state.opt_state, both)
            metrics = dict(metrics, loss=loss)
            return TrainState(state.step + 1, new_craft, new_crnn, new_opt), metrics

        return step

    if state_example is None:
        raise ValueError("state_example is required when sharding over a mesh")
    view = _MeshStep(mesh)
    param_sh = (param_shardings(state_example.craft_params, mesh), param_shardings(state_example.crnn_params, mesh))
    opt_sh = _shard_opt_like(state_example.opt_state, param_sh, mesh)
    split = [sh.axis("tp") is not None for sh in optim.tree_leaves(param_sh)]
    tp_group = mesh.get_group("tp")

    def sum_of_squares(grads) -> torch.Tensor:
        # each split leaf's slices once over the tp group, each replicated leaf once
        squares = [torch.sum(g * g) for g in optim.tree_leaves(grads)]
        local = torch.stack([q for q, s in zip(squares, split) if s]).sum()
        dist.all_reduce(local, group=tp_group)
        return sum(q for q, s in zip(squares, split) if not s) + local

    norm = optim.sum_of_squares(sum_of_squares) if any(split) else contextlib.nullcontext()

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        batch = {k: view.block(v) for k, v in batch.items()}
        both = shard_tree((state.craft_params, state.crnn_params), param_sh)
        with tp_layers(craft, param_sh[0], mesh), tp_layers(crnn, param_sh[1], mesh):
            loss, metrics, grads = value_and_grad(lambda p: loss_fn(p, batch, view.total), both)
        loss, metrics, grads = view.sum((loss, metrics, grads))
        with norm:
            new_both, new_opt = _update(tx, grads, shard_tree(state.opt_state, opt_sh), both)
        new_craft, new_crnn = unshard_tree(new_both, param_sh)
        metrics = dict(metrics, loss=loss)
        return TrainState(state.step + 1, new_craft, new_crnn, unshard_tree(new_opt, opt_sh)), metrics

    return step


def _shard_opt_like(opt_state: Any, param_sh: Any, mesh) -> Any:
    """Optimizer-state shardings: leaves whose tree path ends with a
    parameter path (Adam's mu/nu mirror the parameter tree) take that
    parameter's sharding; everything else (the counts) is replicated."""
    repl = replicate_sharding(mesh)
    flat: Dict[tuple, Any] = {}
    tree_map_with_path(lambda path, sh: flat.__setitem__(path, sh), param_sh)

    def rule(path, leaf):
        for pk, sh in flat.items():
            if len(path) >= len(pk) and path[-len(pk):] == pk:
                return sh
        return repl

    return tree_map_with_path(rule, opt_state)


def craft_model(tree: Any) -> nn.Module:
    """The detector module a flax tree describes: ``CRAFTLite`` for a
    ``LiteBackbone_0`` tree, else ``CRAFT`` (RGB stem)."""
    return CRAFTLite() if "LiteBackbone_0" in tree.get("params", {}) else CRAFT()
