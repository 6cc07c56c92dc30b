"""Sharding rules: batch over ``dp``, large weights over ``tp``.

Counterpart of ``bbocr_tpu/parallel/sharding.py``. The rule is the JAX
package's, decided on each leaf's shape in JAX's layout: a weight of two
or more axes whose last JAX axis is divisible by tp and at least
``min_tp_dim`` long is split over tp along that axis (conv output
channels, the LSTM gate projections); everything else (biases, norm
scales, small convs, the CTC head) is replicated.

The port's parameters are dicts of tensors keyed as the modules' state
dicts (``train/trainer.py::to_params``). Its weights are flax's kernels
laid out for PyTorch (``models/convert.py``): conv kernels HWIO -> OIHW
and Dense kernels (in, out) -> (out, in) put JAX's last axis first, while
the LSTM matrices ``w_ih``/``w_hh`` keep JAX's layout. So the split axis
of a port leaf is 0, or the last for the LSTM matrices.

A ``Sharding`` says where a tensor lives as a ``NamedSharding`` does: per
tensor axis, the mesh dimension it is split over, or None. ``shard_params``
gives each rank its contiguous slice of every split leaf; ``tp_layers``
and ``shard_module`` mark the layers that compute with such slices
(``parallel/collectives.py``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from bbocr_tpu_torch.parallel.collectives import TPSlice, all_gather_cat


@dataclass(frozen=True)
class Sharding:
    mesh: Any
    spec: Tuple[Optional[str], ...] = ()

    def axis(self, name: str) -> Optional[int]:
        """The tensor axis split over mesh dimension ``name``, or None."""
        return self.spec.index(name) if name in self.spec else None


def batch_sharding(mesh) -> Sharding:
    """Leading-axis (batch) sharding over dp."""
    return Sharding(mesh, ("dp",))


def replicate_sharding(mesh) -> Sharding:
    return Sharding(mesh, ())


def _is_lstm_matrix(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in ("w_ih", "w_hh")


def _split_axis(key: str, leaf: torch.Tensor) -> int:
    """The port axis that is JAX's last axis of this leaf."""
    return leaf.ndim - 1 if _is_lstm_matrix(key) else 0


def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over dicts (keys), named tuples (field names) and
    tuples or lists (indices), rebuilt in the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f), path + (f,)) for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(params: Any, mesh, min_tp_dim: int = 512) -> Any:
    """A tree of ``Sharding`` matching ``params`` (a port parameter dict, or
    dicts of them in tuples)."""
    tp = mesh.size(1)

    def rule(path, leaf):
        key = str(path[-1]) if path else ""
        if tp > 1 and hasattr(leaf, "ndim") and leaf.ndim >= 2:
            axis = _split_axis(key, leaf)
            last = leaf.shape[axis]
            if last % tp == 0 and last >= min_tp_dim:
                spec = [None] * leaf.ndim
                spec[axis] = "tp"
                return Sharding(mesh, tuple(spec))
        return Sharding(mesh, ())

    return tree_map_with_path(rule, params)


def _tp(mesh) -> TPSlice:
    return TPSlice(mesh.get_group("tp"), mesh.get_local_rank("tp"), mesh.size(1))


def local_slice(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along its tp axis (``x`` itself
    when replicated)."""
    axis = sharding.axis("tp")
    if axis is None:
        return x
    tp = _tp(sharding.mesh)
    width = x.shape[axis] // tp.size
    return x.narrow(axis, tp.rank * width, width)


def gather_slice(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """The inverse of ``local_slice``: the tp group's slices concatenated."""
    axis = sharding.axis("tp")
    if axis is None:
        return x
    tp = _tp(sharding.mesh)
    return all_gather_cat(x, axis, tp.group, tp.size)


def _zip_map(fn, tree, shardings):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, getattr(tree, f), getattr(shardings, f)) for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, shardings))
    return fn(tree, shardings)


def shard_tree(tree: Any, shardings: Any) -> Any:
    """Each leaf of ``tree`` as this rank holds it under ``shardings``."""
    return _zip_map(lambda x, s: local_slice(x, s) if torch.is_tensor(x) else x, tree, shardings)


def unshard_tree(tree: Any, shardings: Any) -> Any:
    """Each tp-split leaf of ``tree`` gathered whole again over its tp group."""
    return _zip_map(lambda x, s: gather_slice(x, s) if torch.is_tensor(x) else x, tree, shardings)


def shard_params(params: Any, mesh, min_tp_dim: int = 512) -> Any:
    """``params`` with each tp-split leaf replaced by this rank's slice
    (:func:`param_shardings`); the JAX function places a global array,
    whose shard on each device this is."""
    return shard_tree(params, param_shardings(params, mesh, min_tp_dim))


# The layers that compute with a slice of their output channels, and the
# parameters each holds sliced: the layers' ``tp`` attribute is read by
# models/layers.py (Conv2d, Linear), models/crnn.py (VGGFeatures' convs,
# LSTMScan) and nothing else.
def _sliced_layers(model: nn.Module, shardings: dict) -> dict:
    from bbocr_tpu_torch.models.crnn import LSTMScan
    from bbocr_tpu_torch.models.layers import Conv2d, Linear

    layers = {}
    for key, sharding in shardings.items():
        if sharding.axis("tp") is None:
            continue
        path, name = key.rsplit(".", 1)
        module = model.get_submodule(path)
        ok = (isinstance(module, (Conv2d, Linear)) and name == "weight") or (
            isinstance(module, LSTMScan) and name in ("w_ih", "w_hh"))
        if not ok:
            raise ValueError(f"{key}: a {type(module).__name__} does not compute with a tp slice of {name}")
        layers.setdefault(path, (module, []))[1].append(name)
    for path, (module, names) in layers.items():
        if isinstance(module, LSTMScan) and sorted(names) != ["w_hh", "w_ih"]:
            raise ValueError(f"{path}: an LSTMScan splits w_ih and w_hh together, got {names}")
    return {path: module for path, (module, _) in layers.items()}


@contextlib.contextmanager
def tp_layers(model: nn.Module, shardings: dict, mesh):
    """Within the block, the layers whose weights ``shardings`` splits over
    tp compute with this rank's slices (passed in by the caller, as
    ``torch.func.functional_call`` parameters) and gather their outputs."""
    marked = _sliced_layers(model, shardings).values()
    tp = _tp(mesh) if marked else None
    for module in marked:
        module.tp = tp
    try:
        yield
    finally:
        for module in marked:
            del module.tp


def shard_module(model: nn.Module, mesh, min_tp_dim: int = 512) -> dict:
    """Split ``model``'s parameters by :func:`param_shardings`: each split
    weight is replaced by this rank's slice and its layer computes with it
    from then on. Returns the shardings."""
    shardings = param_shardings(dict(model.named_parameters()), mesh, min_tp_dim)
    layers = _sliced_layers(model, shardings)
    for key, sharding in shardings.items():
        path, name = key.rsplit(".", 1)
        if path in layers:
            old = getattr(layers[path], name)
            setattr(layers[path], name, nn.Parameter(local_slice(old.data, sharding).clone(),
                                                     requires_grad=old.requires_grad))
    if layers:
        tp = _tp(mesh)
        for module in layers.values():
            module.tp = tp
    return shardings
