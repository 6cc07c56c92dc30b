"""Flat ``.npz`` parameter trees, as ``bbocr_tpu`` ships them (numpy only).

Keys are ``/``-joined paths of the flax parameter tree, e.g.
``params/VGG16BN_0/ConvBN_0/Conv_0/kernel``. A file written by
``save_params`` loads in the JAX package's ``load_params`` with an equal
tree, and the reverse.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        if hasattr(tree, "detach"):  # a torch tensor
            tree = tree.detach().cpu().numpy()
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_params(path: str, params: Any) -> None:
    """Atomic write (tmp + rename): concurrent readers never see a
    truncated archive. Leaves may be numpy arrays or torch tensors."""
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **_flatten(params))
    os.replace(tmp, path)


def load_params(path: str) -> Any:
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})
