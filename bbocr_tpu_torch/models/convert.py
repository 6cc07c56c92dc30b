"""flax parameter trees -> torch state dicts.

Layout rules: conv kernels HWIO -> OIHW; ``Dense`` kernels (in, out) ->
``Linear`` weights (out, in); ``LSTMScan`` ``w_ih``/``w_hh``/``b_ih`` ->
``weight_ih_l0``/``weight_hh_l0``/``bias_ih_l0`` (``_reverse`` for the
backward direction) with ``bias_hh_l0 = 0``, since the JAX LSTM has one
bias; GroupNorm ``scale``/``bias`` -> ``weight``/``bias``. Load the result
with ``strict=True``: every key on both sides must be used.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


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
    raise KeyError(f"unexpected leaf {leaf!r} under {path}")


def _to_tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _num(name: str) -> str:
    return name.rsplit("_", 1)[1]


def craft_state_dict(params: Any) -> Dict[str, torch.Tensor]:
    """``CRAFT`` (VGG16BN, GroupNorm) flax tree -> ``models.craft.CRAFT`` state dict."""
    sd: Dict[str, np.ndarray] = {}
    for key, value in _leaves(params["params"]):
        parts = key.split("/")
        leaf = parts[-1]
        sub = "conv" if parts[-2].startswith("Conv_") else "norm"
        if parts[0] == "VGG16BN_0":
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


def crnn_state_dict(params: Any) -> Dict[str, torch.Tensor]:
    """``CRNN(norm="group")`` flax tree -> ``models.crnn.CRNN`` state dict."""
    sd: Dict[str, np.ndarray] = {}
    for key, value in _leaves(params["params"]):
        parts = key.split("/")
        leaf = parts[-1]
        if parts[0] == "VGGFeatures_0":
            kind = "convs" if parts[1].startswith("Conv_") else "norms"
            sd.update(_layer(f"features.{kind}.{_num(parts[1])}", leaf, value))
        elif re.fullmatch(r"rnn\d", parts[0]) and parts[1] in ("fwd", "bwd"):
            sfx = "l0" if parts[1] == "fwd" else "l0_reverse"
            base = f"{parts[0]}.lstm"
            if leaf == "w_ih":
                sd[f"{base}.weight_ih_{sfx}"] = value.T
            elif leaf == "w_hh":
                sd[f"{base}.weight_hh_{sfx}"] = value.T
            elif leaf == "b_ih":
                sd[f"{base}.bias_ih_{sfx}"] = value
                sd[f"{base}.bias_hh_{sfx}"] = np.zeros_like(value)
            else:
                raise KeyError(f"unexpected LSTM parameter {key}")
        elif re.fullmatch(r"rnn\d", parts[0]) and parts[1] == "proj":
            sd.update(_layer(f"{parts[0]}.proj", leaf, value))
        elif parts[0] == "head":
            sd.update(_layer("head", leaf, value))
        else:
            raise KeyError(f"unexpected CRNN parameter {key}")
    return _to_tensors(sd)
