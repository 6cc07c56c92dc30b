"""flax parameter trees -> torch state dicts.

Layout rules: conv kernels HWIO -> OIHW; ``Dense`` kernels (in, out) ->
``Linear`` weights (out, in); ``LSTMScan`` ``w_ih``/``w_hh``/``b_ih`` keep
the JAX layout and names (``rnn0.fwd.w_ih``); GroupNorm and BatchNorm
``scale``/``bias`` -> ``weight``/``bias``; the ``batch_stats`` collection's
``mean``/``var`` -> the BatchNorm buffers ``running_mean``/``running_var``.
Load the result with ``strict=True``: every key on both sides must be used.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def _variables(variables: Any) -> Iterator[Tuple[str, np.ndarray]]:
    """The leaves of ``params`` and of ``batch_stats`` (where present)."""
    yield from _leaves(variables["params"])
    yield from _leaves(variables.get("batch_stats", {}))


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v, np.float32)


def _layer(path: str, leaf: str, value: np.ndarray) -> Dict[str, np.ndarray]:
    """One flax layer leaf -> torch (suffix, value) pairs under ``path``."""
    if leaf == "kernel" and value.ndim == 4:
        return {f"{path}.weight": value.transpose(3, 2, 0, 1)}
    if leaf == "kernel":
        return {f"{path}.weight": value.T}
    if leaf == "scale":
        return {f"{path}.weight": value}
    if leaf == "bias":
        return {f"{path}.bias": value}
    if leaf in ("mean", "var"):
        return {f"{path}.running_{leaf}": value}
    raise KeyError(f"unexpected leaf {leaf!r} under {path}")


def _to_tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _num(name: str) -> str:
    return name.rsplit("_", 1)[1]


def craft_state_dict(params: Any) -> Dict[str, torch.Tensor]:
    """A CRAFT flax tree -> the state dict of its ``models.craft`` module:
    ``CRAFT`` (VGG16BN, GroupNorm), ``CRAFTLite`` (``LiteBackbone_0``) or
    ``CRAFTPublished`` (``slice1``, with ``batch_stats``)."""
    if "slice1" in params["params"]:
        return _published_state_dict(params)
    sd: Dict[str, np.ndarray] = {}
    for key, value in _leaves(params["params"]):
        parts = key.split("/")
        leaf = parts[-1]
        sub = "conv" if parts[-2].startswith("Conv_") else "norm"
        if parts[0] == "LiteBackbone_0" and parts[1].startswith("ConvBN_"):
            path = f"backbone.convs.{_num(parts[1])}.{sub}"
        elif parts[0] == "LiteBackbone_0":
            path = "backbone.stem" if sub == "conv" else "backbone.stem_norm"
        elif parts[0] == "VGG16BN_0":
            path = f"backbone.convs.{_num(parts[1])}.{sub}"
        elif parts[0].startswith("DoubleConv_"):
            path = f"decoder.{_num(parts[0])}.{_num(parts[1])}.{sub}"
        elif parts[0].startswith("ConvBN_"):
            path = f"head.{_num(parts[0])}.{sub}"
        elif parts[0] == "Conv_0":
            path = "out"
        else:
            raise KeyError(f"unexpected CRAFT parameter {key}")
        sd.update(_layer(path, leaf, value))
    return _to_tensors(sd)


def _published_state_dict(params: Any) -> Dict[str, torch.Tensor]:
    """``CRAFTPublished`` variables: ``<block>/Conv_i`` -> ``<block>.convs.i``,
    ``<block>/BatchNorm_i`` -> ``<block>.norms.i``, the top-level
    ``Conv_i`` -> ``head.i``."""
    sd: Dict[str, np.ndarray] = {}
    for key, value in _variables(params):
        parts = key.split("/")
        if len(parts) == 2 and parts[0].startswith("Conv_"):
            path = f"head.{_num(parts[0])}"
        elif len(parts) == 3 and re.fullmatch(r"slice\d|upconv\d", parts[0]):
            kind = "convs" if parts[1].startswith("Conv_") else "norms"
            path = f"{parts[0]}.{kind}.{_num(parts[1])}"
        else:
            raise KeyError(f"unexpected CRAFTPublished variable {key}")
        sd.update(_layer(path, parts[-1], value))
    return _to_tensors(sd)


def crnn_state_dict(params: Any) -> Dict[str, torch.Tensor]:
    """A ``CRNN`` flax tree (``norm="group"``, or ``"batch"`` with its
    ``batch_stats``) -> ``models.crnn.CRNN`` state dict."""
    sd: Dict[str, np.ndarray] = {}
    for key, value in _variables(params):
        parts = key.split("/")
        leaf = parts[-1]
        if parts[0] == "VGGFeatures_0":
            kind = "convs" if parts[1].startswith("Conv_") else "norms"
            sd.update(_layer(f"features.{kind}.{_num(parts[1])}", leaf, value))
        elif re.fullmatch(r"rnn\d", parts[0]) and parts[1] in ("fwd", "bwd"):
            if leaf not in ("w_ih", "w_hh", "b_ih"):
                raise KeyError(f"unexpected LSTM parameter {key}")
            sd[f"{parts[0]}.{parts[1]}.{leaf}"] = value
        elif re.fullmatch(r"rnn\d", parts[0]) and parts[1] == "proj":
            sd.update(_layer(f"{parts[0]}.proj", leaf, value))
        elif parts[0] == "head":
            sd.update(_layer("head", leaf, value))
        else:
            raise KeyError(f"unexpected CRNN parameter {key}")
    return _to_tensors(sd)


_ATTN_PARTS = ("query", "key", "value", "out")


def _pagereader_block(prefix: str, parts: list, leaf: str, value: np.ndarray) -> Dict[str, np.ndarray]:
    """A ``Block`` leaf under ``prefix``: ``LayerNorm_i`` -> ``norms.i``,
    ``MultiHeadDotProductAttention_i/{query,key,value,out}`` -> ``attns.i``
    (the ``DenseGeneral`` kernels (d, heads, hd) and (heads, hd, d)
    flattened to (d, d) first), ``Dense_0``/``Dense_1`` -> ``fc1``/``fc2``."""
    name = parts[0]
    if name.startswith("LayerNorm_"):
        return _layer(f"{prefix}.norms.{_num(name)}", leaf, value)
    if name.startswith("MultiHeadDotProductAttention_") and len(parts) == 2 and parts[1] in _ATTN_PARTS:
        path = f"{prefix}.attns.{_num(name)}.{parts[1]}"
        if leaf == "kernel":
            return {f"{path}.weight": value.reshape(-1, value.shape[-1]).T if parts[1] == "out"
                    else value.reshape(value.shape[0], -1).T}
        return _layer(path, leaf, value.reshape(-1))
    if name in ("Dense_0", "Dense_1"):
        return _layer(f"{prefix}.fc{int(_num(name)) + 1}", leaf, value)
    raise KeyError(f"unexpected PageReader block parameter {prefix}/{'/'.join(parts)}/{leaf}")


def pagereader_state_dict(params: Any) -> Dict[str, torch.Tensor]:
    """A ``PageReader`` flax tree (``checkpoints/vlm.npz``) -> the state dict
    of ``models.vlm.PageReader``. ``ctc_head`` is carried over where the
    tree has it (a tree initialised with ``with_ctc=True``); the shipped
    checkpoint has none. The patch conv's (8, 8, 1, dim) kernel becomes a
    (dim, 64) product in (kh, kw) tap order; embeddings keep their layout."""
    sd: Dict[str, np.ndarray] = {}
    for key, value in _variables(params):
        parts = key.split("/")
        leaf = parts[-1]
        if parts[0] == "encoder":
            if parts[1] == "Conv_0":
                sd.update({"encoder.conv.weight": value.reshape(-1, value.shape[-1]).T} if leaf == "kernel"
                          else _layer("encoder.conv", leaf, value))
            elif parts[1] == "LayerNorm_0":
                sd.update(_layer("encoder.norm", leaf, value))
            elif parts[1].startswith("Block_"):
                sd.update(_pagereader_block(f"encoder.blocks.{_num(parts[1])}", parts[2:-1], leaf, value))
            else:
                raise KeyError(f"unexpected PageReader parameter {key}")
        elif re.fullmatch(r"blocks_\d+", parts[0]):
            sd.update(_pagereader_block(f"blocks.{_num(parts[0])}", parts[1:-1], leaf, value))
        elif parts[0] in ("tok_embed", "pos_embed") and leaf == "embedding":
            sd[f"{parts[0]}.weight"] = value
        elif parts[0] in ("out_norm", "head", "ctc_head") and len(parts) == 2:
            sd.update(_layer(parts[0], leaf, value))
        else:
            raise KeyError(f"unexpected PageReader parameter {key}")
    return _to_tensors(sd)


# ---------------------------------------------------------------------------
# The inverse bridge: torch state dicts -> flax parameter trees
# ---------------------------------------------------------------------------


def _flax_leaf(suffix: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """A torch leaf (``weight`` or ``bias``) of a conv, ``Linear`` or
    normalisation -> the flax leaf name and value (the inverse of ``_layer``)."""
    if suffix == "weight" and value.ndim == 4:
        return "kernel", value.transpose(2, 3, 1, 0)
    if suffix == "weight" and value.ndim == 2:
        return "kernel", value.T
    if suffix == "weight":
        return "scale", value
    if suffix == "bias":
        return "bias", value
    raise KeyError(f"unexpected torch leaf {suffix!r}")


def _numpy(sd: Dict[str, Any]) -> Iterator[Tuple[str, np.ndarray]]:
    for key, value in sd.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().float().numpy()
        yield key, np.ascontiguousarray(np.asarray(value, np.float32))


def _put(tree: Dict[str, Any], path: str, value: np.ndarray) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = np.ascontiguousarray(value)


def craft_params(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A ``CRAFT`` or ``CRAFTLite`` state dict (RGB stem) -> its flax tree
    ``{"params": ...}``: the inverse of ``craft_state_dict``."""
    lite = "backbone.stem.weight" in sd
    backbone = "LiteBackbone_0" if lite else "VGG16BN_0"
    tree: Dict[str, Any] = {}
    for key, value in _numpy(sd):
        parts = key.split(".")
        if parts[-2] in ("conv", "norm"):
            layer = "Conv_0" if parts[-2] == "conv" else "GroupNorm_0"
            owner = parts[:-2]
        else:
            layer, owner = None, parts[:-1]
        if owner[0] == "backbone" and owner[1] == "convs":
            path = f"{backbone}/ConvBN_{owner[2]}/{layer}"
        elif owner == ["backbone", "stem"]:
            path = f"{backbone}/Conv_0"
        elif owner == ["backbone", "stem_norm"]:
            path = f"{backbone}/GroupNorm_0"
        elif owner[0] == "decoder":
            path = f"DoubleConv_{owner[1]}/ConvBN_{owner[2]}/{layer}"
        elif owner[0] == "head":
            path = f"ConvBN_{owner[1]}/{layer}"
        elif owner == ["out"]:
            path = "Conv_0"
        else:
            raise KeyError(f"unexpected CRAFT state dict key {key}")
        leaf, v = _flax_leaf(parts[-1], value)
        _put(tree, f"{path}/{leaf}", v)
    return {"params": tree}


def crnn_params(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A ``CRNN(norm="group")`` state dict -> its flax tree
    ``{"params": ...}``: the inverse of ``crnn_state_dict``."""
    tree: Dict[str, Any] = {}
    for key, value in _numpy(sd):
        parts = key.split(".")
        if parts[0] == "features" and parts[1] == "convs":
            leaf, v = _flax_leaf(parts[3], value)
            _put(tree, f"VGGFeatures_0/Conv_{parts[2]}/{leaf}", v)
        elif parts[0] == "features" and parts[1] == "norms":
            leaf, v = _flax_leaf(parts[3], value)
            _put(tree, f"VGGFeatures_0/GroupNorm_{parts[2]}/{leaf}", v)
        elif re.fullmatch(r"rnn\d", parts[0]) and parts[1] in ("fwd", "bwd"):
            _put(tree, "/".join(parts), value)
        elif re.fullmatch(r"rnn\d", parts[0]) and parts[1] == "proj":
            leaf, v = _flax_leaf(parts[2], value)
            _put(tree, f"{parts[0]}/proj/{leaf}", v)
        elif parts[0] == "head":
            leaf, v = _flax_leaf(parts[1], value)
            _put(tree, f"head/{leaf}", v)
        else:
            raise KeyError(f"unexpected CRNN state dict key {key}")
    return {"params": tree}


def _block_params(tree: Dict[str, Any], prefix: str, parts: list, value: np.ndarray, heads: int) -> None:
    """The inverse of ``_pagereader_block`` for one leaf under ``prefix``."""
    if parts[0] == "norms":
        leaf, v = _flax_leaf(parts[2], value)
        _put(tree, f"{prefix}/LayerNorm_{parts[1]}/{leaf}", v)
    elif parts[0] == "attns" and parts[2] in _ATTN_PARTS:
        path = f"{prefix}/MultiHeadDotProductAttention_{parts[1]}/{parts[2]}"
        d = value.shape[0]
        if parts[3] == "weight" and parts[2] == "out":
            _put(tree, f"{path}/kernel", value.T.reshape(heads, d // heads, d))
        elif parts[3] == "weight":
            _put(tree, f"{path}/kernel", value.T.reshape(d, heads, d // heads))
        elif parts[2] == "out":
            _put(tree, f"{path}/bias", value)
        else:
            _put(tree, f"{path}/bias", value.reshape(heads, d // heads))
    elif parts[0] in ("fc1", "fc2"):
        leaf, v = _flax_leaf(parts[1], value)
        _put(tree, f"{prefix}/Dense_{int(parts[0][2]) - 1}/{leaf}", v)
    else:
        raise KeyError(f"unexpected PageReader block key {prefix}.{'.'.join(parts)}")


def pagereader_params(sd: Dict[str, Any], heads: int = 6, patch: int = 8) -> Dict[str, Any]:
    """A ``models.vlm.PageReader`` state dict -> its flax tree
    ``{"params": ...}``: the inverse of ``pagereader_state_dict``. ``heads``
    and ``patch`` are the model's (the state dict does not hold them)."""
    tree: Dict[str, Any] = {}
    for key, value in _numpy(sd):
        parts = key.split(".")
        if parts[0] == "encoder" and parts[1] == "conv" and parts[2] == "weight":
            _put(tree, "encoder/Conv_0/kernel", value.T.reshape(patch, patch, 1, -1))
        elif parts[0] == "encoder" and parts[1] == "conv":
            _put(tree, "encoder/Conv_0/bias", value)
        elif parts[0] == "encoder" and parts[1] == "norm":
            leaf, v = _flax_leaf(parts[2], value)
            _put(tree, f"encoder/LayerNorm_0/{leaf}", v)
        elif parts[0] == "encoder" and parts[1] == "blocks":
            _block_params(tree, f"encoder/Block_{parts[2]}", parts[3:], value, heads)
        elif parts[0] == "blocks":
            _block_params(tree, f"blocks_{parts[1]}", parts[2:], value, heads)
        elif parts[0] in ("tok_embed", "pos_embed"):
            _put(tree, f"{parts[0]}/embedding", value)
        elif parts[0] in ("out_norm", "head", "ctc_head"):
            leaf, v = _flax_leaf(parts[1], value)
            _put(tree, f"{parts[0]}/{leaf}", v)
        else:
            raise KeyError(f"unexpected PageReader state dict key {key}")
    return {"params": tree}
