"""The port's Pillow-free image encoding against Pillow 12 and the JAX
extractor's helpers.

- ``io.pil_thumbnail_u8`` equals ``Image.thumbnail`` bit for bit, over the
  reduce-then-BICUBIC route (4032x3024 to 800), the plain BICUBIC route
  (6048x4536 gray to 3200, 1200x900 to 800), images that already fit, and
  edge shapes; ``ops.pil_reduce_u8`` equals ``Image.reduce``.
- ``io.encode_jpeg`` (the C++ encoder) gives, byte for byte, the JPEG that
  the JAX extractor's ``_encode_jpeg_b64`` writes through Pillow (RGB and
  gray, qualities 50, 88 and 95, tiny and odd sizes, a decoded book photo
  and the preprocessed cover).
- The PNG previews of ``_to_data_url`` decode, with Pillow, to exactly the
  pixels of the JAX extractor's.
"""

import base64
import functools
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from bbocr_tpu.extract.extractor import BookMetadataExtractor as JaxExtractor
from bbocr_tpu_torch.extract.extractor import BookMetadataExtractor
from bbocr_tpu_torch.io import encode_jpeg, encode_png, load_rgb, pil_thumbnail_u8, thumbnail_size
from bbocr_tpu_torch.native import jpeg as native_jpeg
from bbocr_tpu_torch.native import loader
from bbocr_tpu_torch.ops import pil_reduce_u8

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOK_PHOTO = os.path.join(ROOT, "books", "1", "IMG_0001.jpg")
COVER = os.path.join(ROOT, "data", "real", "covers", "book1.png")


def _photo_like(h, w, channels, seed):
    """Smooth structure plus noise: a photo's spectrum, not a flat field."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (np.sin(yy / 37.0) + np.cos(xx / 23.0)) * 60 + 128
    shape = (h, w) if channels is None else (h, w, channels)
    if channels is not None:
        base = base[..., None] + np.arange(channels) * 17.0
    return np.clip(base + rng.integers(-40, 41, shape), 0, 255).astype(np.uint8)


def _pillow_thumbnail(arr, max_dim):
    img = Image.fromarray(arr)
    img.thumbnail((max_dim, max_dim))
    return np.asarray(img)


THUMBNAILS = [  # (H, W, channels), max_dim
    ((3024, 4032, 3), 800),  # reduce by 2, then BICUBIC
    ((4536, 6048, None), 3200),  # BICUBIC alone
    ((900, 1200, 3), 800),
    ((53, 37, 3), 800),  # fits: unchanged
    ((1, 1, 3), 800),
    ((5, 7, 3), 800),
    ((10, 3201, 3), 800),  # reduce along x only, 1-pixel floor on y
    ((5, 7, None), 3),
    ((100, 3, None), 10),
    ((999, 2501, 3), 300),  # reduce by (4, 1)
]


@pytest.mark.parametrize("shape,max_dim", THUMBNAILS, ids=[f"{s[1]}x{s[0]}x{s[2] or 1}-{m}" for s, m in THUMBNAILS])
def test_thumbnail_matches_pillow(shape, max_dim):
    arr = _photo_like(shape[0], shape[1], shape[2], seed=shape[0] + shape[1])
    ref = _pillow_thumbnail(arr, max_dim)
    got = pil_thumbnail_u8(arr, max_dim)
    assert got.shape == ref.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("w,h,max_dim", [(4032, 3024, 800), (3201, 10, 800), (10, 3201, 800), (7, 5, 3),
                                         (1000, 999, 800), (37, 53, 800), (2, 1000, 3)])
def test_thumbnail_size_matches_pillow(w, h, max_dim):
    img = Image.new("L", (w, h))
    img.thumbnail((max_dim, max_dim))
    assert (thumbnail_size(w, h, max_dim) or (w, h)) == img.size


@pytest.mark.parametrize("fx,fy", [(2, 2), (3, 3), (4, 4), (5, 5), (6, 6), (2, 1), (1, 3), (7, 2), (2, 5)])
def test_reduce_matches_pillow(fx, fy):
    rng = np.random.default_rng(fx * 10 + fy)
    for arr in (rng.integers(0, 256, (23, 31), dtype=np.uint8), rng.integers(0, 256, (17, 26, 3), dtype=np.uint8),
                np.full((13, 11), 255, np.uint8)):
        np.testing.assert_array_equal(pil_reduce_u8(arr, fx, fy), np.asarray(Image.fromarray(arr).reduce((fx, fy))))


@functools.lru_cache(maxsize=1)
def _cover_once():
    from bbocr_tpu_torch.preprocess import preprocess_for_book_cover

    pre, _ = preprocess_for_book_cover(load_rgb(COVER), device="cpu")
    return pre.numpy()


def _preprocessed_cover():
    return _cover_once().copy()  # float32 holding uint8 values, as the extractor keeps it


def _jpeg_input(name):
    if name == "book_photo":
        return load_rgb(BOOK_PHOTO)
    if name == "book_photo_gray":
        return load_rgb(BOOK_PHOTO)[..., 1].copy()
    if name == "preprocessed_cover":
        return _preprocessed_cover()
    h, w = (int(v) for v in name.split("_")[0].split("x"))
    return _photo_like(h, w, None if name.endswith("gray") else 3, seed=h * w)


JPEG_INPUTS = ["1x1_rgb", "1x1_gray", "5x7_rgb", "5x7_gray", "33x17_rgb", "33x17_gray", "book_photo", "book_photo_gray"]


@pytest.mark.parametrize("quality", [50, 88, 95])
@pytest.mark.parametrize("name", JPEG_INPUTS)
def test_jpeg_bytes_match_jax_extractor(name, quality):
    """``_encode_jpeg_b64`` of both extractors at the cover's and the other
    photos' sizes (2000 and 3200 px, neither thumbnails these inputs)."""
    arr = _jpeg_input(name)
    for max_dim in (2000, 3200):
        ref = JaxExtractor._encode_jpeg_b64(arr, max_dim, quality)
        got = BookMetadataExtractor._encode_jpeg_b64(arr, max_dim, quality)
        assert got == ref
    assert base64.b64decode(got) == encode_jpeg(arr if arr.dtype == np.uint8 else arr.astype(np.uint8), quality)


@pytest.mark.parametrize("max_dim,quality", [(3200, 95), (2000, 88), (800, 95), (1000, 50)])
def test_jpeg_of_preprocessed_cover_matches_jax_extractor(max_dim, quality):
    """The preprocessed cover (1312x1050 gray in float32), as the model
    receives it, through the thumbnail where ``max_dim`` is smaller; and the
    quality clamp to 50..95."""
    arr = _preprocessed_cover()
    assert arr.shape == (1312, 1050)
    assert BookMetadataExtractor._encode_jpeg_b64(arr, max_dim, quality) == JaxExtractor._encode_jpeg_b64(
        arr, max_dim, quality)
    for out_of_range in (10, 100):
        assert BookMetadataExtractor._encode_jpeg_b64(arr[:64, :48], max_dim, out_of_range) == \
            JaxExtractor._encode_jpeg_b64(arr[:64, :48], max_dim, out_of_range)


def _data_url_pixels(url):
    assert url.startswith("data:image/png;base64,")
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(url.split(",", 1)[1]))))


@pytest.mark.parametrize("name", ["book_photo", "preprocessed_cover", "out_of_range", "5x7_rgb", "1x1_gray"])
def test_png_previews_decode_to_jax_pixels(name):
    if name == "out_of_range":
        arr = np.random.default_rng(3).normal(128, 120, (90, 70)).astype(np.float32)
    else:
        arr = _jpeg_input(name)
    ref = _data_url_pixels(JaxExtractor._to_data_url(arr))
    got = _data_url_pixels(BookMetadataExtractor._to_data_url(arr))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert max(got.shape[:2]) <= 800


def test_previews_return_none_on_error_as_jax():
    bad = np.zeros((1, 5, 5, 3), np.uint8)
    assert JaxExtractor._to_data_url(bad) is None
    assert BookMetadataExtractor._to_data_url(bad) is None
    assert BookMetadataExtractor._to_data_url(None) is None


@pytest.mark.parametrize("arr", [np.zeros((4, 4), np.uint8), np.zeros((3, 5, 3), np.uint8)], ids=["gray", "rgb"])
def test_png_round_trips_through_pillow(arr):
    arr = arr + np.arange(arr.size, dtype=np.uint8).reshape(arr.shape)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(encode_png(arr)))), arr)


def test_encoder_build_without_gpp_names_it(monkeypatch, tmp_path):
    """No fallback to Pillow: when g++ cannot build the encoder, encoding
    raises naming g++."""
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_jpeg, "_encoder", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match=r"g\+\+"):
        encode_jpeg(np.zeros((8, 8, 3), np.uint8), 90)
