"""The port's PNG reader against Pillow, and its schema checker."""

import glob
import os

import numpy as np
import pytest
from PIL import Image

from bbocr_tpu_torch.extract import SchemaError, empty_metadata, validate_metadata, validate_schema
from bbocr_tpu_torch.io import UnsupportedPNG, load_rgb, read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COVERS = sorted(glob.glob(os.path.join(ROOT, "data", "real", "covers", "*.png")))


def test_five_covers_are_found():
    assert len(COVERS) == 5


@pytest.mark.parametrize("path", COVERS, ids=[os.path.basename(p) for p in COVERS])
def test_read_png_matches_pillow_on_covers(path):
    with Image.open(path) as img:
        ref = np.asarray(img)
        rgb = np.asarray(img.convert("RGB"))
    np.testing.assert_array_equal(read_png(path), ref)
    np.testing.assert_array_equal(load_rgb(path), rgb)


@pytest.mark.parametrize("mode,shape", [("L", (37, 53)), ("RGB", (1, 1, 3)), ("RGBA", (29, 41, 4))])
@pytest.mark.parametrize("level", [0, 1, 9])
def test_read_png_matches_pillow_on_synthetic(tmp_path, mode, shape, level):
    """Every scanline filter shows up across these compression levels."""
    arr = np.random.default_rng(level).integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(arr, mode).save(path, compress_level=level)
    np.testing.assert_array_equal(read_png(path), arr)
    with Image.open(path) as img:
        np.testing.assert_array_equal(load_rgb(path), np.asarray(img.convert("RGB")))


def test_read_png_refuses_palette_images(tmp_path):
    path = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").convert("P").save(path)
    with pytest.raises(UnsupportedPNG):
        read_png(path)
    assert load_rgb(path).shape == (4, 4, 3)  # through Pillow


def test_schema_accepts_empty_and_filled_metadata():
    meta = empty_metadata()
    validate_schema(meta)
    meta.update(title="T", authors=["A"], page_count=320, price={"currency": "USD", "amount": 9.5})
    meta["_processing_info"] = {"anything": 1}
    validate_schema(meta)
    assert validate_metadata(meta) == (True, [])


@pytest.mark.parametrize(
    "field,value",
    [("title", 3), ("authors", "A"), ("authors", [1]), ("page_count", "320"),
     ("page_count", True), ("price", {"amount": "9"}), ("price", [])],
)
def test_schema_rejects_wrong_types(field, value):
    meta = empty_metadata()
    meta[field] = value
    with pytest.raises(SchemaError):
        validate_schema(meta)


def test_books_dir_stays_in_the_repository(tmp_path, monkeypatch):
    """The CLI looks for ``books/`` in the repository, never next to it."""
    from bbocr_tpu_torch.cli.process_book import find_books_dir

    (tmp_path / "books").mkdir()
    (tmp_path / "cwd").mkdir()
    monkeypatch.chdir(tmp_path / "cwd")  # "../books" exists from here
    assert find_books_dir() == os.path.join(ROOT, "books")
    assert find_books_dir(str(tmp_path / "books")) == str(tmp_path / "books")
    assert find_books_dir(str(tmp_path / "missing")) is None
