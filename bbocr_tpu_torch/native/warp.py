"""Host crop rectification without OpenCV, through the C++ warp.

``native/warp.cpp`` computes ``cv2.warpPerspective`` (INTER_LINEAR,
WARP_INVERSE_MAP, BORDER_REPLICATE) and ``cv2.resize`` (INTER_AREA at an
integer factor) on uint8 gray images bit for bit as OpenCV 5.0.0 does. It
is built with g++ at first use into ``bbocr_tpu_torch/native/build/``, as
the labeler is (``native/loader.py``), and a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from bbocr_tpu_torch.native.loader import build_library

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "warp.cpp")
_STEM = "libbbocr_warp"
# the source writes out every fused multiply-add it means
_EXTRA_FLAGS = ("-ffp-contract=off",)

_lock = threading.Lock()
_lib = None


def build() -> str:
    return build_library(SOURCE, _STEM, _EXTRA_FLAGS)


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32 = ctypes.c_int32
        lib.bbocr_warp_perspective_u8.restype = ctypes.c_int
        lib.bbocr_warp_perspective_u8.argtypes = [u8p, i32, i32, ctypes.POINTER(ctypes.c_double), u8p, i32, i32]
        lib.bbocr_resize_area_u8.restype = ctypes.c_int
        lib.bbocr_resize_area_u8.argtypes = [u8p, i32, i32, i32, u8p]
        _lib = lib
        return _lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def warp_perspective_u8(src: np.ndarray, m: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """(H, W) uint8 -> (out_h, out_w) uint8 sampled at ``m`` (3, 3), the
    output -> source map; outside the image the border replicates."""
    src = np.ascontiguousarray(src, np.uint8)
    if src.ndim != 2:
        raise ValueError(f"expected a 2-D uint8 image, got shape {src.shape}")
    m = np.ascontiguousarray(m, np.float64).reshape(3, 3)
    out = np.empty((out_h, out_w), np.uint8)
    code = load().bbocr_warp_perspective_u8(
        _u8p(src), src.shape[0], src.shape[1], m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _u8p(out), out_h, out_w,
    )
    if code:
        raise ValueError(f"warp of a {src.shape} image to {out_h}x{out_w} refused")
    return out


def resize_area_u8(src: np.ndarray, k: int) -> np.ndarray:
    """(H * k, W * k) uint8 -> (H, W) uint8, each k x k block averaged."""
    src = np.ascontiguousarray(src, np.uint8)
    h, w = src.shape
    if k < 1 or h % k or w % k:
        raise ValueError(f"a {src.shape} image does not divide by {k}")
    out = np.empty((h // k, w // k), np.uint8)
    if load().bbocr_resize_area_u8(_u8p(src), h // k, w // k, k, _u8p(out)):
        raise ValueError(f"area resize of a {src.shape} image by {k} refused")
    return out
