"""Baseline JPEG decoding without Pillow, through the C++ decoder.

``native/jpeg_decode.cpp`` decodes baseline JPEG bit for bit as the
libjpeg-turbo in Pillow does (integer IDCT, fancy upsampling, fixed-point
YCbCr -> RGB). It is built with g++ at first use into
``bbocr_tpu_torch/native/build/``, as the labeler is (``native/loader.py``),
and a failed build raises. Decoding is host work, as it is in Pillow.
Progressive, arithmetic-coded, lossless, 12-bit, CMYK and Adobe-transform
files raise ``UnsupportedJPEG``.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from bbocr_tpu_torch.native.loader import build_library

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg_decode.cpp")
_STEM = "libbbocr_jpeg"
_ERR_LEN = 256
_CORRUPT, _UNSUPPORTED = 1, 2

_lock = threading.Lock()
_lib = None


class UnsupportedJPEG(ValueError):
    """A JPEG variant the port's decoder does not decode."""


def build() -> str:
    return build_library(SOURCE, _STEM)


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        for fn in (lib.bbocr_jpeg_header, lib.bbocr_jpeg_decode):
            fn.restype = ctypes.c_int
        lib.bbocr_jpeg_header.argtypes = [u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int32]
        lib.bbocr_jpeg_decode.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int32]
        _lib = lib
        return _lib


def _check(code: int, err, name: str) -> None:
    if code == 0:
        return
    msg = f"{name}: {err.value.decode(errors='replace')}"
    if code == _UNSUPPORTED:
        raise UnsupportedJPEG(f"{msg}: the port decodes baseline JPEG only, see ROADMAP.md Queue 1")
    raise ValueError(f"{msg} (corrupt JPEG)")


def decode_jpeg(blob: bytes, name: str = "JPEG") -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, or (H, W) for a gray JPEG."""
    lib = load()
    data = np.frombuffer(blob, np.uint8)
    src = data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    err = ctypes.create_string_buffer(_ERR_LEN)
    dims = (ctypes.c_int32 * 3)()
    _check(lib.bbocr_jpeg_header(src, data.size, dims, err, _ERR_LEN), err, name)
    h, w, c = dims
    out = np.empty((h, w, c), np.uint8)
    _check(lib.bbocr_jpeg_decode(src, data.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size, err, _ERR_LEN), err, name)
    return out[..., 0] if c == 1 else out


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
