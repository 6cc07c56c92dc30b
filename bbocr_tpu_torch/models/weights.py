"""Weight transforms on flax parameter trees (numpy only).

Counterpart of ``bbocr_tpu/models/weights.py::fold_gray_stem``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from bbocr_tpu_torch.models.craft import IMAGENET_MEAN, IMAGENET_STD

_STEM = ("VGG16BN_0", "ConvBN_0", "Conv_0")


def fold_gray_stem(craft_params: Mapping[str, Any]) -> Dict[str, Any]:
    """Fold gray->RGB repeat + /255 + ImageNet normalize into CRAFT's conv1.

    Each step is affine per channel, ``x_c = g / (255 std_c) - mean_c /
    std_c``. The fold uses two input channels, the gray plane and a ones
    plane carrying the mean shift, so that zero padding at the borders
    zeroes both exactly as the reference path zeroes x there:

        k0[..., o] = sum_c W[..., c, o] / (255 std_c)
        k1[k, o]   = -sum_c W[k, c, o] * mean_c / std_c

    Use with ``CRAFT(gray_input=True)`` on raw gray inputs in [0, 255].
    Idempotent; the caller's tree is not mutated.
    """
    params = dict(craft_params)
    node = params["params"]
    for key in _STEM:
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
    for key in _STEM[:-1]:
        cursor[key] = dict(cursor[key])
        cursor = cursor[key]
    cursor[_STEM[-1]] = new_conv
    return {**params, "params": top}
