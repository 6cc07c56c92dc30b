"""What the JAX trainer takes from optax, written out in PyTorch.

The trainer's optimizer is ``chain(clip_by_global_norm(c), adamw(lr,
weight_decay=wd))`` (``bbocr_tpu/train/trainer.py::make_optimizer``). This
module computes it in optax's order and float32 arithmetic:

- ``clip_by_global_norm``: ``where(norm < max, g, g / norm * max)``, with the
  norm ``sqrt(sum_leaves(sum(g * g)))`` (``clip_grad_norm_`` scales by
  ``max / (norm + 1e-6)`` instead);
- ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0):
  ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, ``count + 1``,
  ``u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)``;
- ``add_decayed_weights``: ``u + wd * p`` on every leaf;
- ``scale_by_learning_rate``: ``-lr(count) * u``, the schedule's own count
  starting at 0 (a constant rate keeps no state);
- ``apply_updates``: ``p + u``.

``torch.optim.AdamW`` decays the weights before the Adam step and rounds in
another order, so it is not used. Parameter trees are dicts (and tuples) of
tensors; the optimizer state mirrors optax's: ``(EmptyState(),
(ScaleByAdamState(count, mu, nu), EmptyState(), ScaleByScheduleState(count)
or EmptyState()))``, counts as 0-d int32 tensors on the parameters' device.
``to_optax`` and ``from_optax`` convert it to and from optax's leaves.

The schedules are optax's (``linear_schedule``, ``cosine_decay_schedule``,
``warmup_cosine_decay_schedule``) evaluated on the count tensor in float32.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Callable, NamedTuple, Tuple, Union

import numpy as np
import torch


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


Schedule = Callable[[torch.Tensor], torch.Tensor]


# ---------------------------------------------------------------------------
# Trees: dicts, tuples and lists of tensors
# ---------------------------------------------------------------------------


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _first_tensor(tree) -> torch.Tensor:
    return tree_leaves(tree)[0]


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to float32 as a 0-d tensor on ``like``'s device
    (a weakly typed Python float takes the array's type in JAX)."""
    return torch.tensor(float(np.float32(value)), dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Schedules (optax.schedules), on a 0-d int32 count tensor
# ---------------------------------------------------------------------------


def constant_schedule(value: float) -> Schedule:
    return lambda count: _f32(value, count)


def linear_schedule(init_value: float, end_value: float, transition_steps: int, transition_begin: int = 0) -> Schedule:
    """optax's ``polynomial_schedule`` with power 1."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count):
        c = torch.clamp(count - transition_begin, 0, transition_steps)
        frac = _f32(1.0, count) - c.float() / _f32(transition_steps, count)
        return _f32(init_value - end_value, count) * frac + _f32(end_value, count)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        c = torch.minimum(count.float(), _f32(decay_steps, count))
        cosine = _f32(0.5, count) * (_f32(1.0, count) + torch.cos(_f32(math.pi, count) * c / _f32(decay_steps, count)))
        decayed = _f32(1.0 - alpha, count) * cosine + _f32(alpha, count)
        return _f32(init_value, count) * decayed

    return schedule


def join_schedules(schedules, boundaries) -> Schedule:
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out, sched(count - boundary))
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [
            linear_schedule(init_value, peak_value, warmup_steps),
            cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha),
        ],
        [warmup_steps],
    )


# ---------------------------------------------------------------------------
# Transformations
# ---------------------------------------------------------------------------


# Under tensor parallelism a step's leaves are this rank's slices of the
# split weights: its sum of squares must count each slice once over the tp
# group and each replicated leaf once (train/trainer.py installs it).
_SUM_OF_SQUARES = contextvars.ContextVar("sum_of_squares", default=None)


@contextlib.contextmanager
def sum_of_squares(fn: Callable):
    """Within the block, ``global_norm(tree)`` is ``sqrt(fn(tree))``."""
    token = _SUM_OF_SQUARES.set(fn)
    try:
        yield
    finally:
        _SUM_OF_SQUARES.reset(token)


def global_norm(tree) -> torch.Tensor:
    fn = _SUM_OF_SQUARES.get()
    if fn is not None:
        return torch.sqrt(fn(tree))
    return torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(tree)))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        return EmptyState()

    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        limit = _f32(max_norm, g_norm)
        return tree_map(lambda t: torch.where(trigger, t, t / g_norm * limit), updates), state

    return GradientTransformation(init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        zeros = tree_map(torch.zeros_like, params)
        count = torch.zeros((), dtype=torch.int32, device=_first_tensor(params).device)
        return ScaleByAdamState(count, zeros, tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        like = _first_tensor(updates)
        c1, d1 = _f32(1 - b1, like), _f32(b1, like)
        c2, d2 = _f32(1 - b2, like), _f32(b2, like)
        mu = tree_map(lambda g, t: c1 * g + d1 * t, updates, state.mu)
        nu = tree_map(lambda g, t: c2 * (g * g) + d2 * t, updates, state.nu)
        count = state.count + 1
        one = _f32(1.0, like)
        bc1 = one - torch.pow(d1, count.float())
        bc2 = one - torch.pow(d2, count.float())
        e = _f32(eps, like)
        zero = _f32(0.0, like)
        out = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2 + zero) + e), mu, nu)
        return out, ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def init(params):
        return EmptyState()

    def update(updates, state, params):
        s = _f32(weight_decay, _first_tensor(updates))
        return tree_map(lambda g, p: g + s * p, updates, params), state

    return GradientTransformation(init, update)


def scale_by_learning_rate(learning_rate: Union[float, Schedule]) -> GradientTransformation:
    if callable(learning_rate):
        def init(params):
            return ScaleByScheduleState(torch.zeros((), dtype=torch.int32, device=_first_tensor(params).device))

        def update(updates, state, params=None):
            step = -learning_rate(state.count)
            return tree_map(lambda g: step * g, updates), ScaleByScheduleState(state.count + 1)

        return GradientTransformation(init, update)

    def init(params):
        return EmptyState()

    def update(updates, state, params=None):
        step = _f32(-learning_rate, _first_tensor(updates))
        return tree_map(lambda g: step * g, updates), state

    return GradientTransformation(init, update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay), scale_by_learning_rate(learning_rate))


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# ---------------------------------------------------------------------------
# optax's state <-> this module's
# ---------------------------------------------------------------------------


def to_optax(state, to_flax: Callable = lambda tree: tree) -> Tuple:
    """This module's state -> the same nesting of plain tuples with numpy
    leaves, each parameter tree passed through ``to_flax`` (a torch state
    dict -> its flax tree). Its leaves, in order, are optax's:
    ``jax.tree_util.tree_unflatten(tree_structure(tx.init(p)),
    tree_leaves(to_optax(...)))`` rebuilds optax's state."""

    def conv(node):
        if isinstance(node, ScaleByAdamState):
            return (_np(node.count), to_flax(_np_tree(node.mu)), to_flax(_np_tree(node.nu)))
        if isinstance(node, ScaleByScheduleState):
            return (_np(node.count),)
        if isinstance(node, EmptyState):
            return ()
        return tuple(conv(n) for n in node)

    return conv(state)


def from_optax(opt_state, like, to_torch: Callable = lambda tree: tree):
    """optax's state of ``chain(clip_by_global_norm, adamw)`` -> this
    module's, shaped as ``like`` (a state of this module); ``to_torch`` maps
    a flax tree of numpy arrays to a state dict of tensors."""
    device = _first_tensor(like[1][0].mu).device

    def conv(node, ref):
        if isinstance(ref, ScaleByAdamState):
            count, mu, nu = node
            return ScaleByAdamState(_tensor(count, device), _to(to_torch(mu), device), _to(to_torch(nu), device))
        if isinstance(ref, ScaleByScheduleState):
            return ScaleByScheduleState(_tensor(node[0], device))
        if isinstance(ref, EmptyState):
            return EmptyState()
        return tuple(conv(n, r) for n, r in zip(node, ref))

    return conv(opt_state, like)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _np_tree(tree):
    return tree_map(_np, tree)


def _tensor(value, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(value)).to(device)


def _to(tree, device):
    return tree_map(lambda v: torch.as_tensor(np.array(v, np.float32)).to(device), tree)
