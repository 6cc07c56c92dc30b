"""Flat ``.npz`` parameter trees, as ``bbocr_tpu`` ships them (numpy only).

Keys are ``/``-joined paths of the flax parameter tree, e.g.
``params/VGG16BN_0/ConvBN_0/Conv_0/kernel``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def load_params(path: str) -> Any:
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})
