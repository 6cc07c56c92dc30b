"""The port's host crop rectification (``runtime/wire.py``, the C++ warp in
``native/warp.cpp``) bit for bit against OpenCV 5.0.0, as the JAX package
calls it (``bbocr_tpu/runtime/wire.py::host_warp_crop``).

Seeded quads on random images (inside, across and beyond the border,
tilted, supersampled at k = 1 to 4, output widths on both sides of the
16-pixel vector block), and the real quads of ``book1.png``'s reading.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from bbocr_tpu.runtime.rectify import quad_to_rect_homography as jax_homography
from bbocr_tpu.runtime.wire import host_warp_crop as jax_host_warp_crop
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.native.warp import resize_area_u8, warp_perspective_u8
from bbocr_tpu_torch.runtime.engine import _to_gray_u8
from bbocr_tpu_torch.runtime.rectify import quad_to_rect_homography
from bbocr_tpu_torch.runtime.wire import host_warp_crop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOK1 = os.path.join(ROOT, "data", "real", "covers", "book1.png")
FLAGS = cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP

torch.set_num_threads(2)


def _quad(rng, h, w, inside=True):
    cx, cy = (rng.uniform(0, w), rng.uniform(0, h)) if inside else (rng.uniform(-0.3 * w, 1.3 * w), rng.uniform(-0.3 * h, 1.3 * h))
    bw, bh = rng.uniform(6, 1.1 * w), rng.uniform(4, h / 1.5)
    ang = rng.normal(0, 0.3)
    c, s = np.cos(ang), np.sin(ang)
    corners = np.array([[-bw / 2, -bh / 2], [bw / 2, -bh / 2], [bw / 2, bh / 2], [-bw / 2, bh / 2]])
    return corners @ np.array([[c, s], [-s, c]]) + [cx, cy] + rng.normal(0, 3, (4, 2))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("inside", [True, False], ids=["inside", "beyond_border"])
def test_warp_perspective_is_cv2(k, inside):
    rng = np.random.default_rng(10 * k + inside)
    for _ in range(12):
        h, w = int(rng.integers(20, 400)), int(rng.integers(20, 600))
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        out_w = int(rng.integers(1, 130)) * k
        m = quad_to_rect_homography(_quad(rng, h, w, inside), out_w, 32 * k)
        ref = cv2.warpPerspective(img, m, (out_w, 32 * k), flags=FLAGS, borderMode=cv2.BORDER_REPLICATE)
        np.testing.assert_array_equal(warp_perspective_u8(img, m, out_w, 32 * k), ref)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_resize_area_is_cv2(k):
    rng = np.random.default_rng(k)
    for flat in (False, True):
        w = int(rng.integers(1, 300))
        # few levels: many block sums land on a rounding tie
        img = (rng.integers(0, 4, (32 * k, w * k)) + 100 if flat else rng.integers(0, 256, (32 * k, w * k))).astype(np.uint8)
        ref = cv2.resize(img, (w, 32), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(resize_area_u8(img, k), ref)


def test_host_warp_crop_is_jax_on_seeded_quads():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (700, 900)).astype(np.uint8)
    for i in range(40):
        q = _quad(rng, 700, 900, inside=i % 4 != 0)
        h_src = max(np.linalg.norm(q[3] - q[0]), np.linalg.norm(q[2] - q[1]))
        true_w = int(np.clip(round(32 * np.linalg.norm(q[1] - q[0]) / max(h_src, 1e-6)), 8, 512))
        bucket = max(true_w, int(rng.choice([64, 128, 256, 384, 512])))
        ref = jax_host_warp_crop(img, q, true_w, 32, bucket, jax_homography)
        np.testing.assert_array_equal(host_warp_crop(img, q, true_w, 32, bucket, quad_to_rect_homography), ref)


def test_host_warp_crop_is_jax_on_book1_quads():
    """The quads of the JAX package's reading of ``book1.png``
    (``tests/data/book1_jax_f32.json``, preprocessed-image coordinates),
    warped from the gray cover scaled as the preprocessing scales it."""
    with open(os.path.join(ROOT, "tests", "data", "book1_jax_f32.json")) as f:
        quads = json.load(f)["quads"]
    gray = _to_gray_u8(load_rgb(BOOK1))
    gray = cv2.resize(gray, (int(gray.shape[1] * 1.5), int(gray.shape[0] * 1.5)), interpolation=cv2.INTER_CUBIC)
    ks = set()
    for q in quads:
        q = np.asarray(q, np.float64)
        h_src = max(np.linalg.norm(q[3] - q[0]), np.linalg.norm(q[2] - q[1]))
        ks.add(int(np.clip(round(h_src / 32), 1, 4)))
        true_w = int(np.clip(round(32 * np.linalg.norm(q[1] - q[0]) / max(h_src, 1e-6)), 8, 512))
        ref = jax_host_warp_crop(gray, q, true_w, 32, 512, jax_homography)
        np.testing.assert_array_equal(host_warp_crop(gray, q, true_w, 32, 512, quad_to_rect_homography), ref)
    assert len(ks) > 1  # the cover's lines take more than one supersampling factor


def test_warp_rejects_bad_input():
    with pytest.raises(ValueError):
        warp_perspective_u8(np.zeros((4, 4, 3), np.uint8), np.eye(3), 4, 4)
    with pytest.raises(ValueError):
        resize_area_u8(np.zeros((9, 8), np.uint8), 2)
