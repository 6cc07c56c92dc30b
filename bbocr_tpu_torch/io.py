"""Image loading without Pillow.

``read_png`` decodes 8-bit gray, RGB and RGBA PNGs that are not interlaced
with the standard library's ``zlib`` and numpy. The five scanline filters
are undone along anti-diagonals: a pixel depends only on its left, upper
and upper-left neighbours, so every pixel of one anti-diagonal can be
decoded at once whatever filter each row uses. Other images (JPEG, palette
or 16-bit PNG) go through Pillow, imported only then.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

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
        blob = f.read()
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


def _read_with_pillow(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: reading this image needs Pillow, which is not installed "
            "(PNGs of 8-bit gray, RGB or RGBA are read without it)"
        ) from e
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def load_rgb(path_or_array) -> np.ndarray:
    """A path or an array -> (H, W, 3) uint8 RGB (alpha dropped, gray repeated)."""
    if isinstance(path_or_array, np.ndarray):
        arr = path_or_array
    elif str(path_or_array).lower().endswith(".png"):
        try:
            arr = read_png(str(path_or_array))
        except UnsupportedPNG:
            arr = _read_with_pillow(str(path_or_array))
    else:
        arr = _read_with_pillow(str(path_or_array))
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr[..., :3].astype(np.uint8)
