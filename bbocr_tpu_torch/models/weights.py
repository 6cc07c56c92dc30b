"""Weight imports and transforms on flax parameter trees (numpy).

Counterpart of ``bbocr_tpu/models/weights.py``:

- ``import_crnn_from_torch``: an EasyOCR generation-2 recognizer state dict
  -> the flax variables of ``CRNN(num_classes, norm="batch")`` (conv OIHW
  -> HWIO; BatchNorm weight/bias/running statistics -> scale/bias and
  ``batch_stats``; each LSTM's ``bias_ih + bias_hh`` folded into one bias,
  gates i, f, g, o; Linear (out, in) -> (in, out));
- ``import_craft_from_torch``: a published CRAFT state dict (the
  craft_mlt_25k layout) -> the flax variables of ``CRAFTPublished``;
- ``load_craft_torch_checkpoint``, ``load_crnn_torch_checkpoint``:
  ``torch.load`` of a ``.pth`` and the import;
- ``fold_gray_stem``.

The results are flax trees, which ``models.convert`` turns into the port's
state dicts, so imported weights load as the repository's ``.npz`` do.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from bbocr_tpu_torch.models.craft import IMAGENET_MEAN, IMAGENET_STD


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _strip_prefixes(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = _np(v)
    return out


def _conv(sd, torch_idx: int, bias: bool = True) -> Dict[str, np.ndarray]:
    w = sd[f"FeatureExtraction.ConvNet.{torch_idx}.weight"].transpose(2, 3, 1, 0)
    entry = {"kernel": w}
    if bias:
        entry["bias"] = sd[f"FeatureExtraction.ConvNet.{torch_idx}.bias"]
    return entry


def _bn(sd, torch_idx: int):
    base = f"FeatureExtraction.ConvNet.{torch_idx}"
    params = {"scale": sd[f"{base}.weight"], "bias": sd[f"{base}.bias"]}
    stats = {"mean": sd[f"{base}.running_mean"], "var": sd[f"{base}.running_var"]}
    return params, stats


def _lstm(sd, base: str, reverse: bool) -> Dict[str, np.ndarray]:
    sfx = "_reverse" if reverse else ""
    w_ih = sd[f"{base}.rnn.weight_ih_l0{sfx}"]  # (4H, C)
    w_hh = sd[f"{base}.rnn.weight_hh_l0{sfx}"]  # (4H, H)
    b = sd[f"{base}.rnn.bias_ih_l0{sfx}"] + sd[f"{base}.rnn.bias_hh_l0{sfx}"]
    return {"w_ih": w_ih.T, "w_hh": w_hh.T, "b_ih": b}


def _linear(sd, base: str) -> Dict[str, np.ndarray]:
    return {"kernel": sd[f"{base}.weight"].T, "bias": sd[f"{base}.bias"]}


def import_crnn_from_torch(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """EasyOCR gen-2 recognizer state dict -> flax variables for
    ``CRNN(num_classes=N, norm="batch")``.

    Returns the full variables dict ({"params": ..., "batch_stats": ...});
    the vocabulary size is inferred from the Prediction head.
    """
    sd = _strip_prefixes(state_dict)

    bn0_p, bn0_s = _bn(sd, 12)
    bn1_p, bn1_s = _bn(sd, 15)
    vgg_params = {
        "Conv_0": _conv(sd, 0),
        "Conv_1": _conv(sd, 3),
        "Conv_2": _conv(sd, 6),
        "Conv_3": _conv(sd, 8),
        "Conv_4": _conv(sd, 11, bias=False),
        "BatchNorm_0": bn0_p,
        "Conv_5": _conv(sd, 14, bias=False),
        "BatchNorm_1": bn1_p,
        "Conv_6": _conv(sd, 18),
    }
    vgg_stats = {"BatchNorm_0": bn0_s, "BatchNorm_1": bn1_s}

    def bilstm(i: int) -> Dict[str, Any]:
        base = f"SequenceModeling.{i}"
        return {
            "fwd": _lstm(sd, base, reverse=False),
            "bwd": _lstm(sd, base, reverse=True),
            "proj": _linear(sd, f"{base}.linear"),
        }

    params = {
        "VGGFeatures_0": vgg_params,
        "rnn0": bilstm(0),
        "rnn1": bilstm(1),
        "head": _linear(sd, "Prediction"),
    }
    batch_stats = {"VGGFeatures_0": vgg_stats}
    return {"params": params, "batch_stats": batch_stats}


# Published CRAFT basenet slice layout: torchvision vgg16_bn feature
# indices, kept as module names by the published Sequential assembly
# (state-dict keys like ``basenet.slice3.24.weight``). Convs and BNs per
# slice; slice outputs are PRE-ReLU after the listed final BN.
_CRAFT_SLICES = {
    "slice1": ([0, 3, 7, 10], [1, 4, 8, 11]),
    "slice2": ([14, 17], [15, 18]),
    "slice3": ([20, 24, 27], [21, 25, 28]),
    "slice4": ([30, 34, 37], [31, 35, 38]),
}


def import_craft_from_torch(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Published CRAFT state dict (craft_mlt_25k layout) -> flax variables
    for ``CRAFTPublished``. Inference-only (BatchNorm stats frozen)."""
    sd = _strip_prefixes(state_dict)

    def conv(base: str) -> Dict[str, np.ndarray]:
        return {
            "kernel": sd[f"{base}.weight"].transpose(2, 3, 1, 0),
            "bias": sd[f"{base}.bias"],
        }

    def bn(base: str):
        p = {"scale": sd[f"{base}.weight"], "bias": sd[f"{base}.bias"]}
        s = {"mean": sd[f"{base}.running_mean"], "var": sd[f"{base}.running_var"]}
        return p, s

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for name, (convs, bns) in _CRAFT_SLICES.items():
        sp: Dict[str, Any] = {}
        ss: Dict[str, Any] = {}
        for i, ci in enumerate(convs):
            sp[f"Conv_{i}"] = conv(f"basenet.{name}.{ci}")
        for i, bi in enumerate(bns):
            p, s = bn(f"basenet.{name}.{bi}")
            sp[f"BatchNorm_{i}"] = p
            ss[f"BatchNorm_{i}"] = s
        params[name] = sp
        stats[name] = ss
    params["slice5"] = {
        "Conv_0": conv("basenet.slice5.1"),
        "Conv_1": conv("basenet.slice5.2"),
    }
    for u in range(1, 5):
        p0, s0 = bn(f"upconv{u}.conv.1")
        p1, s1 = bn(f"upconv{u}.conv.4")
        params[f"upconv{u}"] = {
            "Conv_0": conv(f"upconv{u}.conv.0"),
            "Conv_1": conv(f"upconv{u}.conv.3"),
            "BatchNorm_0": p0,
            "BatchNorm_1": p1,
        }
        stats[f"upconv{u}"] = {"BatchNorm_0": s0, "BatchNorm_1": s1}
    for i, ti in enumerate((0, 2, 4, 6, 8)):
        params[f"Conv_{i}"] = conv(f"conv_cls.{ti}")
    return {"params": params, "batch_stats": stats}


def load_craft_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Convenience: torch.load the published .pth and convert."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return import_craft_from_torch(sd)


def load_crnn_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Convenience: torch.load the .pth and convert."""
    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return import_crnn_from_torch(sd)


def fold_gray_stem(craft_params: Mapping[str, Any]) -> Dict[str, Any]:
    """Fold gray->RGB repeat + /255 + ImageNet normalize into CRAFT's conv1.

    Each step is affine per channel, ``x_c = g / (255 std_c) - mean_c /
    std_c``. The fold uses two input channels, the gray plane and a ones
    plane carrying the mean shift, so that zero padding at the borders
    zeroes both exactly as the reference path zeroes x there:

        k0[..., o] = sum_c W[..., c, o] / (255 std_c)
        k1[k, o]   = -sum_c W[k, c, o] * mean_c / std_c

    Use with ``CRAFT(gray_input=True)`` or ``CRAFTLite(gray_input=True)``
    (whose stride-2 stem is a bare conv) on raw gray inputs in [0, 255].
    Idempotent; the caller's tree is not mutated.
    """
    params = dict(craft_params)
    if "LiteBackbone_0" in params["params"]:
        path = ("LiteBackbone_0", "Conv_0")
    else:
        path = ("VGG16BN_0", "ConvBN_0", "Conv_0")
    node = params["params"]
    for key in path:
        node = node[key]
    w = np.asarray(node["kernel"], np.float32)  # (3, 3, 3, out)
    if w.shape[2] == 2:
        return params
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    k_gray = (w / (255.0 * std[None, None, :, None])).sum(axis=2, keepdims=True)
    k_ones = -(w * (mean / std)[None, None, :, None]).sum(axis=2, keepdims=True)
    new_conv = dict(node)
    new_conv["kernel"] = np.concatenate([k_gray, k_ones], axis=2).astype(w.dtype)
    top = dict(params["params"])
    cursor = top
    for key in path[:-1]:
        cursor[key] = dict(cursor[key])
        cursor = cursor[key]
    cursor[path[-1]] = new_conv
    return {**params, "params": top}
