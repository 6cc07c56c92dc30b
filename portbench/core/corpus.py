"""Inputs drawn from the seed, and the decoders' check against recorded digests.

A traffic file names its corpus by globs relative to the checkout's root.
Every seed sends the same photos, each once per cycle, in the order of a
permutation drawn from the seed, so that runs of different seeds do the
same work in another order.
"""

from __future__ import annotations

import glob
import hashlib
import os
from typing import Dict, List, Sequence

import numpy as np

from portbench.core.registry import PORTBENCH, ROOT, load_json

DIGESTS = os.path.join(PORTBENCH, "data", "gray_sha256.json")


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for any whole-number seed (negative or above 64 bits too)."""
    return np.random.default_rng([seed & (2**64 - 1), (seed >> 64) & (2**64 - 1), stream])


def paths(globs: Sequence[str], root: str = ROOT) -> List[str]:
    """The corpus as paths relative to ``root``, in a fixed order."""
    out: List[str] = []
    for g in globs:
        out += sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, g)))
    if not out:
        raise FileNotFoundError(f"no input matches {list(globs)} under {root}")
    return out


def order(seed: int, n: int) -> np.ndarray:
    return rng(seed).permutation(n)


def sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def digest_mismatches(decoded: Dict[str, np.ndarray], table: str) -> List[str]:
    """The paths whose decoded gray plane differs from the digest recorded
    for it (cv2's ``IMREAD_GRAYSCALE`` read for ``cv2_gray``, Pillow's
    ``convert("L")`` for ``pil_l``), or that have none."""
    want = load_json(DIGESTS)[table]
    bad = []
    for path, arr in decoded.items():
        rec = want.get(path)
        u8 = np.asarray(arr).astype(np.uint8)
        if rec is None or list(u8.shape) != rec["shape"] or sha256(u8) != rec["sha256"]:
            bad.append(path)
    return bad
