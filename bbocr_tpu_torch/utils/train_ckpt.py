"""Resumable trainer state (params + optimizer + step) as flat ``.npz``.

Counterpart of ``bbocr_tpu/utils/train_ckpt.py``, with the same directory
rule (``step_N`` or ``latest`` under the state directory, the highest step
wins). The JAX package writes orbax directories; orbax is not on the card's
machine, so the port writes its own format: each checkpoint is a directory
holding ``state.npz``, whose keys are the ``/``-joined paths of the state's
tree (dict keys, tuple indices). Orbax directories are not read and the
port's are not orbax's (ROADMAP.md Queue 3); model ``.npz`` files
(``utils/checkpoint.py``) move both ways.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

_FILE = "state.npz"


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)


def save_train_state(directory: str, state: Any, step: Optional[int] = None) -> str:
    """Save a state tree (dicts, tuples and NamedTuples of tensors or
    numbers); returns the checkpoint path. Written to a temporary directory
    and renamed, so a reader never sees half a checkpoint."""
    path = os.path.abspath(os.path.join(directory, f"step_{int(step)}" if step is not None else "latest"))
    flat: Dict[str, np.ndarray] = {}
    _flatten(state, "", flat)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _FILE), **flat)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue
        elif name == "latest":
            steps.append((-1, name))
    if not steps:
        return None
    return os.path.join(directory, max(steps)[1])


def _restore(example: Any, prefix: str, data) -> Any:
    if isinstance(example, dict):
        return {k: _restore(v, f"{prefix}{k}/", data) for k, v in example.items()}
    if isinstance(example, (tuple, list)):
        items = [_restore(v, f"{prefix}{i}/", data) for i, v in enumerate(example)]
        return type(example)(*items) if hasattr(example, "_fields") else type(example)(items)
    value = data[prefix[:-1]]
    if isinstance(example, torch.Tensor):
        return torch.from_numpy(np.array(value)).to(device=example.device, dtype=example.dtype)
    if isinstance(example, (int, float)):
        return type(example)(value)
    return value


def restore_train_state(path: str, example_state: Any) -> Any:
    """Restore into the structure of ``example_state``: tensors land on the
    device and in the type of the example's, numbers become its numbers."""
    with np.load(os.path.join(path, _FILE)) as data:
        return _restore(example_state, "", data)
