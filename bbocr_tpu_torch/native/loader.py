"""Build the C++ connected-components labeler with g++ and bind it.

``build_library`` builds any of the package's C++ sources the same way
(``native/jpeg.py`` builds the JPEG decoder with it, ``native/warp.py`` the
host crop warp).

Counterpart of ``bbocr_tpu/native/loader.py``. The library is built at
first use into ``bbocr_tpu_torch/native/build/``, named by a hash of the
source, through a process-unique temporary file renamed into place. Unlike
the JAX package's loader, a failed build raises: the engine has no silent
slow path. The numpy labeler below is kept only as the plain version the
tests hold the native one against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from collections import deque

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "cc_labeling.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

# Max quads per extraction call, and components per labeling call.
MAX_QUADS = 4096
MAX_COMPONENTS = 8192

_lock = threading.Lock()
_lib = None


def build_library(source: str, stem: str, extra_flags: tuple = ()) -> str:
    """g++ ``source`` into ``build/<stem>_<hash>.so`` unless it is there;
    raises if g++ fails."""
    flags = _FLAGS + tuple(extra_flags)
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"{stem}_{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        ["g++", *flags, "-o", tmp, source], capture_output=True, text=True, timeout=300
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def build() -> str:
    return build_library(SOURCE, "libbbocr_native")


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32 = ctypes.c_int32
        lib.bbocr_label_components.restype = i32
        lib.bbocr_label_components.argtypes = [
            u8p, ctypes.POINTER(ctypes.c_float), i32, i32, i32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double), i32,
        ]
        lib.bbocr_extract_quads_masked.restype = i32
        lib.bbocr_extract_quads_masked.argtypes = [
            u8p, u8p, i32, i32, ctypes.c_float, i32, ctypes.POINTER(ctypes.c_double), i32,
        ]
        _lib = lib
        return _lib


def extract_quads_masked_native(
    mask: np.ndarray, score_u8: np.ndarray, text_threshold: float, min_size: int
) -> np.ndarray:
    """Detection postprocessing in one C++ call, from the device-thresholded
    mask and the uint8 region map (round(score * 255)).

    Returns (N, 4, 2) float64 quads, top-left first, clockwise."""
    mask = np.ascontiguousarray(mask != 0, np.uint8)
    score_u8 = np.ascontiguousarray(score_u8, np.uint8)
    h, w = mask.shape
    quads = np.empty((MAX_QUADS, 4, 2), np.float64)
    n = load().bbocr_extract_quads_masked(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        score_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, float(text_threshold) * 255.0, int(min_size),
        quads.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), MAX_QUADS,
    )
    return quads[:n].copy()


def connected_components(mask: np.ndarray, score: np.ndarray | None = None, connectivity: int = 8):
    """Label a binary mask in one C++ call: (labels int32 HxW, stats (N, 11)
    float64) with stats columns x0, y0, x1, y1 (inclusive bbox), count,
    sum_x, sum_y, sum_xx, sum_yy, sum_xy, max_score. Counterpart of
    ``bbocr_tpu/native/loader.py::connected_components``; at most
    ``MAX_COMPONENTS`` components, as there."""
    mask = np.ascontiguousarray(mask != 0, np.uint8)
    h, w = mask.shape
    labels = np.empty((h, w), np.int32)
    stats = np.zeros((MAX_COMPONENTS, 11), np.float64)
    score_arr = None if score is None else np.ascontiguousarray(score, np.float32)
    n = load().bbocr_label_components(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        None if score_arr is None else score_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, int(connectivity),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        MAX_COMPONENTS,
    )
    return labels, stats[:n].copy()


def connected_components_numpy(mask: np.ndarray, score: np.ndarray | None = None, connectivity: int = 8):
    """Plain BFS labeling: (labels int32 HxW, stats (N, 11) float64) with
    stats columns x0, y0, x1, y1 (inclusive bbox), count, sum_x, sum_y,
    sum_xx, sum_yy, sum_xy, max_score, as the C++ labeler computes them."""
    mask = np.asarray(mask) != 0
    h, w = mask.shape
    labels = np.zeros((h, w), np.int32)
    stats = []
    if connectivity == 8:
        nbrs = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]
    else:
        nbrs = [(-1, 0), (0, -1), (0, 1), (1, 0)]
    nid = 0
    for yy in range(h):
        for xx in range(w):
            if not mask[yy, xx] or labels[yy, xx]:
                continue
            nid += 1
            q = deque([(yy, xx)])
            labels[yy, xx] = nid
            x0 = x1 = xx
            y0 = y1 = yy
            cnt = 0
            sx = sy = sxx = syy = sxy = 0.0
            mx = 0.0
            while q:
                cy, cx = q.popleft()
                cnt += 1
                sx += cx
                sy += cy
                sxx += cx * cx
                syy += cy * cy
                sxy += cx * cy
                x0, x1 = min(x0, cx), max(x1, cx)
                y0, y1 = min(y0, cy), max(y1, cy)
                if score is not None:
                    mx = max(mx, float(score[cy, cx]))
                for dy, dx in nbrs:
                    ny, nx = cy + dy, cx + dx
                    if 0 <= ny < h and 0 <= nx < w and mask[ny, nx] and not labels[ny, nx]:
                        labels[ny, nx] = nid
                        q.append((ny, nx))
            stats.append([x0, y0, x1, y1, cnt, sx, sy, sxx, syy, sxy, mx])
    return labels, np.asarray(stats, np.float64).reshape(-1, 11)
