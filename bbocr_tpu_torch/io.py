"""Image loading and encoding without Pillow.

``read_png`` decodes 8-bit gray, RGB and RGBA PNGs that are not interlaced
with the standard library's ``zlib`` and numpy. The five scanline filters
are undone along anti-diagonals: a pixel depends only on its left, upper
and upper-left neighbours, so every pixel of one anti-diagonal can be
decoded at once whatever filter each row uses. Baseline JPEGs are decoded
by the C++ decoder of ``native/jpeg.py``, bit for bit as Pillow decodes
them. Other images (progressive JPEG, palette or 16-bit PNG, other formats)
go through Pillow, imported only then. ``decode_rgb`` does the same for
an image's bytes, by their signature, and ``load_gray`` gives what
Pillow's ``convert("L")`` gives of either (``pil_gray_u8``: its 16-bit
fixed-point luma). ``imread_gray`` gives what OpenCV's
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` gives of a PNG or a baseline
JPEG: libpng's RGB-to-gray rule, libjpeg's luma plane.

The encoding side reproduces what the JAX extractor asks of Pillow:
``pil_thumbnail_u8`` is ``Image.thumbnail`` (Pillow 12: the aspect-keeping
size, ``reduce`` by whole factors while the source is over twice the
target, then BICUBIC over the reduced box), ``encode_png`` writes a PNG
whose pixels are the array's, and ``encode_jpeg`` is the C++ baseline
encoder of ``native/jpeg.py``, byte-equal with Pillow's JPEG.
"""

from __future__ import annotations

import io
import math
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from bbocr_tpu_torch.native.jpeg import UnsupportedJPEG, decode_jpeg, decode_jpeg_luma, encode_rgb, read_jpeg
from bbocr_tpu_torch.ops.resize import pil_reduce_u8, pil_resample_u8

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG color type -> samples per pixel


class UnsupportedPNG(ValueError):
    """A PNG variant ``read_png`` does not decode."""


def _unfilter(raw: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    rows = raw.reshape(h, 1 + w * c)
    ftype = rows[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise ValueError("corrupt PNG: unknown filter type")
    data = rows[:, 1:].reshape(h, w, c).astype(np.int32)
    # out[1:, 1:] holds the decoded image; row 0 and column 0 are the zero
    # neighbours the filters see outside the image.
    out = np.zeros((h + 1, w + 1, c), np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        col = d - r
        a = out[r + 1, col]  # left
        b = out[r, col + 1]  # up
        ul = out[r, col]  # upper left
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        f = ftype[r][:, None]
        pred = np.select(
            [f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], default=0
        )
        out[r + 1, col + 1] = (data[r, col] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """(H, W) uint8 for gray PNGs, (H, W, 3) or (H, W, 4) for RGB / RGBA."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(blob: bytes, path: str = "PNG") -> np.ndarray:
    """``read_png`` of PNG bytes (``path`` names them in errors)."""
    if not blob.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos = len(_PNG_SIGNATURE)
    header = None
    idat = []
    while pos + 8 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        body = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise UnsupportedPNG(
            f"{path}: bit depth {depth}, color type {color}, interlace {interlace}; "
            "read_png takes 8-bit gray, RGB or RGBA without interlacing"
        )
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"{path}: corrupt PNG: image data has the wrong size")
    img = _unfilter(raw, h, w, c)
    return img[..., 0] if c == 1 else img


def _read_with_pillow(source, why: str = "", name: Optional[str] = None) -> np.ndarray:
    """``source`` (a path or a file object) in RGB through Pillow; ``name``
    stands for it in the error."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{name or source}: reading this image needs Pillow, which is not installed "
            f"(PNGs of 8-bit gray, RGB or RGBA and baseline JPEGs are read without it){why}"
        ) from e
    with Image.open(source) as img:
        return np.asarray(img.convert("RGB"))


def _as_rgb(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr[..., :3].astype(np.uint8)


def load_rgb(path_or_array) -> np.ndarray:
    """A path or an array -> (H, W, 3) uint8 RGB (alpha dropped, gray repeated)."""
    if isinstance(path_or_array, np.ndarray):
        arr = path_or_array
    elif str(path_or_array).lower().endswith(".png"):
        try:
            arr = read_png(str(path_or_array))
        except UnsupportedPNG:
            arr = _read_with_pillow(str(path_or_array))
    elif str(path_or_array).lower().endswith((".jpg", ".jpeg")):
        try:
            arr = read_jpeg(str(path_or_array))
        except UnsupportedJPEG as e:
            arr = _read_with_pillow(str(path_or_array), f": {e}")
    else:
        arr = _read_with_pillow(str(path_or_array))
    return _as_rgb(arr)


def decode_rgb(blob: bytes, name: str = "image") -> np.ndarray:
    """An image's bytes -> (H, W, 3) uint8 RGB, as ``load_rgb`` reads a file:
    PNGs and baseline JPEGs (told by their signatures) without Pillow,
    anything else through it."""
    try:
        if blob.startswith(_PNG_SIGNATURE):
            return _as_rgb(decode_png(blob, name))
        if blob.startswith(b"\xff\xd8"):
            return _as_rgb(decode_jpeg(blob, name))
        why = ""
    except (UnsupportedPNG, UnsupportedJPEG) as e:
        why = f": {e}"
    return _as_rgb(_read_with_pillow(io.BytesIO(blob), why, name))


# Pillow's convert("L"): ITU-R 601-2 luma in 16-bit fixed point,
# (19595 R + 38470 G + 7471 B + 0x8000) >> 16 (not cv2's 15-bit RGB2GRAY)
_L24 = np.array([19595, 38470, 7471], np.int32)


def pil_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """``Image.fromarray(rgb).convert("L")`` of an (H, W, 3) uint8 array
    (alpha, where there is one, ignored as Pillow ignores it)."""
    return ((rgb[..., :3].astype(np.int32) @ _L24 + 0x8000) >> 16).astype(np.uint8)


def load_gray(source) -> np.ndarray:
    """``np.asarray(Image.open(source).convert("L"), np.float32)`` without
    Pillow, for a path (``load_rgb``) or an image's bytes (``decode_rgb``)."""
    rgb = decode_rgb(source) if isinstance(source, bytes) else load_rgb(source)
    return pil_gray_u8(rgb).astype(np.float32)


# libpng's png_set_rgb_to_gray default (ITU-R 601 0.299 and 0.587 in 15-bit
# fixed point, blue the rest), truncated: what OpenCV reads as gray from an
# 8-bit RGB PNG
_PNG_GRAY = np.array([9797, 19234, 3737], np.int32)


def png_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """libpng's RGB-to-gray of an (H, W, 3) uint8 array:
    ``(9797 R + 19234 G + 3737 B) >> 15``."""
    return ((rgb.astype(np.int32) @ _PNG_GRAY) >> 15).astype(np.uint8)


def imread_gray(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` without OpenCV, bit for bit
    (OpenCV 5.0.0), for PNGs of 8-bit gray or RGB and baseline JPEGs: a
    gray PNG as it is, an RGB PNG by ``png_gray_u8``, a JPEG as libjpeg's
    luma plane (``decode_jpeg_luma``). Any other PNG kind (RGBA, palette,
    16-bit, interlaced) and any other format raise ``ValueError`` naming
    it, rather than guess at OpenCV's conversion."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob.startswith(b"\xff\xd8"):
        return decode_jpeg_luma(blob, path)
    if not blob.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: imread_gray reads PNG and baseline JPEG only")
    arr = decode_png(blob, path)
    if arr.ndim == 2:
        return arr
    if arr.shape[2] != 3:
        raise UnsupportedPNG(f"{path}: an RGBA PNG; imread_gray reads 8-bit gray and RGB PNGs only")
    return png_gray_u8(arr)


def as_u8_image(arr) -> np.ndarray:
    """``np.clip(arr, 0, 255).astype(np.uint8)``: the array the JAX
    extractor hands to ``Image.fromarray``."""
    return np.clip(np.asarray(arr), 0, 255).astype(np.uint8)


def thumbnail_size(w: int, h: int, max_dim: int) -> Optional[Tuple[int, int]]:
    """``Image.thumbnail((max_dim, max_dim))``'s target (width, height), or
    None when the image already fits. Pillow 12's ``preserve_aspect_ratio``:
    of the floor and the ceiling of the scaled side, the one whose aspect
    is closer to the source's, at least 1."""
    x = y = math.floor(max_dim)
    if x >= w and y >= h:
        return None

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = w / h
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect, key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def pil_thumbnail_u8(arr: np.ndarray, max_dim: int) -> np.ndarray:
    """``Image.fromarray(arr).thumbnail((max_dim, max_dim))`` on a (H, W) or
    (H, W, 3) uint8 array, bit for bit (Pillow 12, ``reducing_gap=2.0``).

    Where the source is at least twice the target times 2 along an axis it
    is first reduced by ``int(ratio / 2)`` there (block means, the last
    block partial), and BICUBIC then resamples the reduced image over the
    source's box in the reduced coordinates."""
    if arr.dtype != np.uint8:
        raise ValueError(f"pil_thumbnail_u8 takes uint8, got {arr.dtype}")
    h, w = arr.shape[:2]
    size = thumbnail_size(w, h, max_dim)
    if size is None or size == (w, h):
        return arr.copy()
    tw, th = size
    fx = int(w / tw / 2.0) or 1
    fy = int(h / th / 2.0) or 1
    if fx == 1 and fy == 1:
        return pil_resample_u8(arr, tw, th, "bicubic")
    # the reduce box is the whole image: the bicubic support never reaches
    # past it
    return pil_resample_u8(pil_reduce_u8(arr, fx, fy), tw, th, "bicubic", (0.0, 0.0, w / fx, h / fy))


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 -> PNG bytes (8-bit, no filter,
    ``zlib`` level 6). The pixels equal Pillow's PNG of the same array; the
    bytes need not."""
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (arr.ndim == 3 and arr.shape[2] != 3):
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3) uint8, got {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if arr.ndim == 2 else 2, 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", header) + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def encode_jpeg(arr: np.ndarray, quality: int) -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 -> the bytes of
    ``Image.fromarray(arr).convert("RGB").save(buf, "JPEG", quality=quality)``
    (gray is repeated into RGB first, as ``convert`` does)."""
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3):
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3) uint8, got {arr.dtype} {arr.shape}")
    rgb = np.repeat(arr[..., None], 3, axis=2) if arr.ndim == 2 else arr
    return encode_rgb(rgb, quality)
