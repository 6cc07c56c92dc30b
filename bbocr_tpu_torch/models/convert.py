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
