"""Baseline JPEG decoding and encoding without Pillow, in C++.

``native/jpeg_decode.cpp`` decodes baseline JPEG bit for bit as the
libjpeg-turbo in Pillow does (integer IDCT, fancy upsampling, fixed-point
YCbCr -> RGB). It is built with g++ at first use into
``bbocr_tpu_torch/native/build/``, as the labeler is (``native/loader.py``),
and a failed build raises. Decoding is host work, as it is in Pillow.
Progressive, arithmetic-coded, lossless, 12-bit, CMYK and Adobe-transform
files raise ``UnsupportedJPEG``.

``native/jpeg_encode.cpp`` encodes RGB as Pillow's libjpeg-turbo does for
``Image.save(buf, "JPEG", quality=q)``, byte for byte (4:2:0, standard
tables, islow DCT). It is built the same way, and a failed build raises
naming g++.

``decode_jpeg_luma`` is the decoder's grayscale output, libjpeg's
``JCS_GRAYSCALE`` (what OpenCV's ``IMREAD_GRAYSCALE`` reads): the Y
component through the same IDCT, with no colour conversion.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from bbocr_tpu_torch.native.loader import build_library

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg_decode.cpp")
ENCODER_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg_encode.cpp")
_STEM = "libbbocr_jpeg"
_ENCODER_STEM = "libbbocr_jpeg_encode"
_ERR_LEN = 256
_CORRUPT, _UNSUPPORTED = 1, 2

_lock = threading.Lock()
_lib = None
_encoder = None


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
        for fn in (lib.bbocr_jpeg_header, lib.bbocr_jpeg_decode, lib.bbocr_jpeg_decode_luma):
            fn.restype = ctypes.c_int
        lib.bbocr_jpeg_header.argtypes = [u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int32]
        for fn in (lib.bbocr_jpeg_decode, lib.bbocr_jpeg_decode_luma):
            fn.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int32]
        _lib = lib
        return _lib


def build_encoder() -> str:
    return build_library(ENCODER_SOURCE, _ENCODER_STEM)


def load_encoder() -> ctypes.CDLL:
    global _encoder
    with _lock:
        if _encoder is None:
            lib = ctypes.CDLL(build_encoder())
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.bbocr_jpeg_encode.restype = ctypes.c_int64
            lib.bbocr_jpeg_encode.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8p, ctypes.c_int64]
            _encoder = lib
        return _encoder


def encode_rgb(rgb: np.ndarray, quality: int) -> bytes:
    """(H, W, 3) uint8 RGB -> baseline JPEG bytes at ``quality`` (1..100)."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3 or min(rgb.shape[:2]) < 1:
        raise ValueError(f"encode_rgb takes a non-empty (H, W, 3) uint8 array, got {rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    if max(h, w) > 65535:
        raise ValueError(f"a baseline JPEG is at most 65535 pixels on a side, got {w}x{h}")
    lib = load_encoder()
    src = np.ascontiguousarray(rgb)
    # at most 16 bits of code and 16 of value per coefficient, doubled by
    # 0xFF stuffing, for the six blocks of each 16x16 MCU
    cap = ((h + 15) // 16) * ((w + 15) // 16) * 6 * 64 * 8 + 1024
    out = np.empty(cap, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.bbocr_jpeg_encode(src.ctypes.data_as(u8p), h, w, int(quality), out.ctypes.data_as(u8p), cap)
    if n < 0:
        raise RuntimeError(f"JPEG encoder overflowed its {cap}-byte buffer")
    return out[:n].tobytes()


def _check(code: int, err, name: str) -> None:
    if code == 0:
        return
    msg = f"{name}: {err.value.decode(errors='replace')}"
    if code == _UNSUPPORTED:
        raise UnsupportedJPEG(f"{msg}: the port decodes baseline JPEG only, see ROADMAP.md Queue 1")
    raise ValueError(f"{msg} (corrupt JPEG)")


def _decode(blob: bytes, name: str, luma: bool) -> np.ndarray:
    lib = load()
    data = np.frombuffer(blob, np.uint8)
    src = data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    err = ctypes.create_string_buffer(_ERR_LEN)
    dims = (ctypes.c_int32 * 3)()
    _check(lib.bbocr_jpeg_header(src, data.size, dims, err, _ERR_LEN), err, name)
    h, w, c = dims
    out = np.empty((h, w, 1 if luma else c), np.uint8)
    fn = lib.bbocr_jpeg_decode_luma if luma else lib.bbocr_jpeg_decode
    _check(fn(src, data.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size, err, _ERR_LEN), err, name)
    return out[..., 0] if out.shape[2] == 1 else out


def decode_jpeg(blob: bytes, name: str = "JPEG") -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, or (H, W) for a gray JPEG."""
    return _decode(blob, name, luma=False)


def decode_jpeg_luma(blob: bytes, name: str = "JPEG") -> np.ndarray:
    """JPEG bytes -> (H, W) uint8: the luma plane, as libjpeg decodes to
    grayscale (no colour conversion; a subsampled Y upsampled as for RGB)."""
    return _decode(blob, name, luma=True)


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
