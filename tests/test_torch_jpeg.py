"""Image input without Pillow, against Pillow, on the CPU.

- The port's baseline-JPEG decoder (``bbocr_tpu_torch.native.jpeg``, C++)
  against Pillow's libjpeg-turbo on every JPEG of the repository (99:
  ``books/`` and ``data/real/photos/``), which must also reproduce the
  digests recorded in ``tests/data/jpeg_pillow_sha256.json`` (the card's
  machine has no Pillow and checks those), and on synthetic JPEGs that
  cover the sampling factors, sizes under one block, gray images, restart
  markers, optimised Huffman tables and 16-bit quantisation tables.
  ``scripts/torch_port_reference.py --jpeg-digests`` times both decoders
  over the 99 files.
- ``ops.pil_bilinear_resize_u8`` (numpy) against Pillow's ``BILINEAR``
  resample at the extractor's 1600 and 2400 px limits and on seeded
  random images.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.native import jpeg
from bbocr_tpu_torch.ops import pil_bilinear_resize_u8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "tests", "data", "jpeg_pillow_sha256.json")) as _f:
    DIGESTS = json.load(_f)


def test_every_repository_jpeg_has_a_digest():
    from glob import glob

    found = glob(os.path.join(ROOT, "books", "*", "*")) + glob(os.path.join(ROOT, "data", "real", "photos", "*", "*"))
    jpegs = sorted(os.path.relpath(p, ROOT) for p in found if p.lower().endswith((".jpg", ".jpeg")))
    assert jpegs == sorted(DIGESTS) and len(jpegs) == 99


@pytest.mark.parametrize("rel", sorted(DIGESTS))
def test_decoder_matches_pillow_on_repository_jpegs(rel):
    path = os.path.join(ROOT, rel)
    with Image.open(path) as img:
        ref = np.asarray(img.convert("RGB"))
    got = load_rgb(path)  # through the port's decoder
    np.testing.assert_array_equal(got, ref)
    assert list(got.shape) == DIGESTS[rel]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS[rel]["sha256"]


def _picture(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """Smooth gradients with noise: every DCT band and both chroma planes get work."""
    y, x = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    base = np.sin(x / 7.0)[..., None] * 80 + np.cos(y / 5.0)[..., None] * 60 + 128
    base = base + np.arange(channels) * 25 + rng.normal(0, 20, (h, w, channels))
    return np.clip(base, 0, 255).astype(np.uint8)


def _encode(arr: np.ndarray, mode: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


SIZES = [(1, 1), (2, 3), (7, 5), (8, 8), (17, 33), (37, 53), (101, 3), (64, 65)]


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("mode,kw", [
    ("RGB", {"subsampling": 0}), ("RGB", {"subsampling": 1}), ("RGB", {"subsampling": 2}), ("L", {}),
], ids=["444", "422", "420", "gray"])
def test_decoder_matches_pillow_on_synthetic(size, mode, kw):
    h, w = size
    arr = _picture(h, w, 3 if mode == "RGB" else 1, h * w)
    blob = _encode(arr if mode == "RGB" else arr[..., 0], mode, quality=85, **kw)
    with Image.open(io.BytesIO(blob)) as img:
        ref = np.asarray(img)
    np.testing.assert_array_equal(jpeg.decode_jpeg(blob), ref)


@pytest.mark.parametrize("mode,kw", [
    ("RGB", {"restart_marker_blocks": 1}),
    ("RGB", {"restart_marker_rows": 1}),
    ("L", {"restart_marker_blocks": 3}),
    ("RGB", {"optimize": True}),
    ("RGB", {"quality": 100, "subsampling": 0}),
    ("RGB", {"quality": 5}),
    ("RGB", {"qtables": [[300] * 64, [2] * 64]}),  # 16-bit quantisation table
], ids=["restart_blocks", "restart_rows", "gray_restart", "optimized", "q100", "q5", "qtable16"])
def test_decoder_matches_pillow_on_encoder_options(mode, kw):
    arr = _picture(61, 77, 3 if mode == "RGB" else 1, 7)
    blob = _encode(arr if mode == "RGB" else arr[..., 0], mode, **{"quality": 90, "subsampling": 2, **kw})
    with Image.open(io.BytesIO(blob)) as img:
        ref = np.asarray(img)
    np.testing.assert_array_equal(jpeg.decode_jpeg(blob), ref)


@pytest.mark.parametrize("mode,kw,what", [
    ("RGB", {"progressive": True}, "progressive"),
    ("CMYK", {}, "Adobe"),
], ids=["progressive", "cmyk"])
def test_decoder_refuses_unsupported_variants(tmp_path, mode, kw, what):
    """Refused naming ROADMAP Queue 1; ``load_rgb`` hands such a file to
    Pillow where it is installed."""
    blob = _encode(_picture(20, 24, len(mode), 1), mode, **kw)
    with pytest.raises(jpeg.UnsupportedJPEG, match=f"{what}.*ROADMAP.md Queue 1"):
        jpeg.decode_jpeg(blob)
    path = tmp_path / "x.jpg"
    path.write_bytes(blob)
    with Image.open(path) as img:
        np.testing.assert_array_equal(load_rgb(str(path)), np.asarray(img.convert("RGB")))


@pytest.mark.parametrize("blob", [b"", b"\xff\xd8\xff\xd9", b"not a jpeg"], ids=["empty", "no_frame", "garbage"])
def test_decoder_rejects_corrupt_data(blob):
    with pytest.raises(ValueError, match="corrupt JPEG"):
        jpeg.decode_jpeg(blob)


def test_decoder_rejects_a_truncated_file():
    blob = _encode(_picture(40, 40, 3, 2), "RGB", quality=90)
    with pytest.raises(ValueError, match="corrupt JPEG"):
        jpeg.decode_jpeg(blob[: len(blob) // 2])


# (input (H, W), output (H, W)): the preprocessed photos of the repository
# (x1.5) to the extractor's 1600 px (first OCR'd image) and 2400 px limits,
# then odd up- and downscales of random images.
RESIZES = [
    ((2700, 3600), (1200, 1600)),
    ((2700, 3600), (1800, 2400)),
    ((3393, 2545), (1600, 1200)),
    ((3600, 2172), (2400, 1448)),
    ((50, 70), (13, 9)),
    ((50, 70), (7, 100)),
    ((1, 9), (1, 4)),
    ((37, 41), (41, 37)),
    ((300, 200), (299, 201)),
    ((64, 64), (128, 32)),
]


@pytest.mark.parametrize("src,dst", RESIZES, ids=[f"{s[0]}x{s[1]}_to_{d[0]}x{d[1]}" for s, d in RESIZES])
def test_pil_bilinear_resize_matches_pillow(src, dst):
    img = np.random.default_rng(src[0] + dst[1]).integers(0, 256, src).astype(np.uint8)
    ref = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), Image.BILINEAR))
    np.testing.assert_array_equal(pil_bilinear_resize_u8(img, dst[1], dst[0]), ref)


def test_pil_bilinear_resize_on_a_preprocessed_photo():
    """A photo-like input (smooth, not noise) at the extractor's first limit."""
    with Image.open(os.path.join(ROOT, "data", "real", "photos", "3", "IMG_9687.jpg")) as img:
        gray = np.asarray(img.convert("L").resize((3600, 2700), Image.BICUBIC))
    ref = np.asarray(Image.fromarray(gray).resize((1600, 1200), Image.BILINEAR))
    np.testing.assert_array_equal(pil_bilinear_resize_u8(gray, 1600, 1200), ref)
