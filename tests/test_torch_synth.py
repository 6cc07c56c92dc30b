"""The port's synthetic data generators are the JAX package's, bit for bit.

``bbocr_tpu_torch/train/synth.py`` and ``photo_aug.py`` are copies that
import Pillow only inside the functions that draw; with the same seeds and
the same fonts (``_find_fonts`` of each package) every array they return
equals the JAX package's in dtype, shape and every element: text-line
batches at widths 64 and 256, page batches with their heatmaps, labeled
pages with JSON and text targets and CTC labels, held-out pages of
``render_labeled``, and each ``photo_aug`` function on its own.
"""

import os
import random

import numpy as np
import pytest

from bbocr_tpu.train import photo_aug as jax_aug
from bbocr_tpu.train import synth as jax_synth
from bbocr_tpu_torch.train import photo_aug as port_aug
from bbocr_tpu_torch.train import synth as port_synth


def _assert_equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_fonts_are_the_jax_packages():
    want = [os.path.basename(p) for p in jax_synth._find_fonts()]
    assert [os.path.basename(p) for p in port_synth._find_fonts()] == want
    assert len(want) > 6
    cover = {os.path.basename(p): v for p, v in jax_synth._FONT_COVERAGE.items()}
    assert {os.path.basename(p): v for p, v in port_synth._FONT_COVERAGE.items()} == cover


@pytest.mark.parametrize("seed", [0, 5, 12345])
@pytest.mark.parametrize("width", [64, 256])
def test_text_line_batches_are_bit_equal(seed, width):
    want = jax_synth.TextLineGenerator(jax_synth.SynthConfig(), seed=seed).batch(6, width=width)
    got = port_synth.TextLineGenerator(port_synth.SynthConfig(), seed=seed).batch(6, width=width)
    _assert_equal(got, want)


def test_text_lines_of_another_charset_and_no_augmentation_are_bit_equal():
    from bbocr_tpu.models.charset import CHARSETS as JAX_CHARSETS
    from bbocr_tpu_torch.models.charset import CHARSETS

    want = jax_synth.TextLineGenerator(
        jax_synth.SynthConfig(charset=JAX_CHARSETS["latin_ext"], photo_aug=0.0, style_aug=0.0), seed=3).batch(4)
    got = port_synth.TextLineGenerator(
        port_synth.SynthConfig(charset=CHARSETS["latin_ext"], photo_aug=0.0, style_aug=0.0), seed=3).batch(4)
    _assert_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7, 4242])
def test_page_batches_are_bit_equal(seed):
    want = jax_synth.PageGenerator(jax_synth.SynthConfig(), seed=seed).batch(2, 256, 192)
    got = port_synth.PageGenerator(port_synth.SynthConfig(), seed=seed).batch(2, 256, 192)
    _assert_equal(got, want)


@pytest.mark.parametrize("seed", [1, 99])
@pytest.mark.parametrize("target", ["json", "text"])
@pytest.mark.parametrize("with_ctc", [False, True])
def test_labeled_pages_are_bit_equal(seed, target, with_ctc):
    want = jax_synth.PageGenerator(jax_synth.SynthConfig(), seed=seed).batch_labeled(
        2, 128, 96, target=target, with_ctc=with_ctc)
    got = port_synth.PageGenerator(port_synth.SynthConfig(), seed=seed).batch_labeled(
        2, 128, 96, target=target, with_ctc=with_ctc)
    _assert_equal(got, want)


def test_held_out_pages_are_bit_equal():
    want = jax_synth.PageGenerator(jax_synth.SynthConfig(), seed=777_777)
    got = port_synth.PageGenerator(port_synth.SynthConfig(), seed=777_777)
    for _ in range(3):
        _assert_equal(got.render_labeled(256, 192), want.render_labeled(256, 192))


def _page(seed, h=64, w=48):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (h, w)).astype(np.float32), rng.random((h // 2, w // 2, 2)).astype(np.float32)


# name -> call(module, random.Random): each photo_aug function on small inputs
AUG_CALLS = {
    "lighting_gradient": lambda m, r: m.lighting_gradient(r, 40, 56),
    "vignette": lambda m, r: m.vignette(r, 40, 56),
    "glare_spot": lambda m, r: m.glare_spot(r, 40, 56),
    "shadow_band": lambda m, r: m.shadow_band(r, 40, 56),
    "paper_texture": lambda m, r: m.paper_texture(r, 40, 56),
    "jpeg_artifacts": lambda m, r: m.jpeg_artifacts(r, _page(1)[0]),
    "gaussian_blur": lambda m, r: m.gaussian_blur(r, _page(2)[0]),
    "motion_blur": lambda m, r: m.motion_blur(r, _page(3)[0]),
    "lowres_cycle": lambda m, r: m.lowres_cycle(r, _page(4)[0]),
    "photometric_crop_aug": lambda m, r: m.photometric_crop_aug(r, _page(5, 32, 96)[0]),
    "photometric_crop_aug_half": lambda m, r: m.photometric_crop_aug(r, _page(5, 32, 96)[0], strength=0.5),
    "perspective_coeffs": lambda m, r: m.perspective_coeffs(
        ((0, 0), (50, 0), (50, 60), (0, 60)), ((3, 2), (47, 1), (49, 58), (1, 57))),
    "warp_page_and_maps": lambda m, r: m.warp_page_and_maps(r, *_page(6)),
    "art_background": lambda m, r: m.art_background(r, 64, 48),
    "real_texture_background": lambda m, r: m.real_texture_background(r, 64, 48),
    "cover_background": lambda m, r: m.cover_background(r, 64, 48),
    "clutter_background": lambda m, r: m.clutter_background(r, 64, 48),
    "page_in_scene": lambda m, r: m.page_in_scene(r, *_page(7)),
}


@pytest.mark.parametrize("name", sorted(AUG_CALLS))
@pytest.mark.parametrize("seed", [0, 31])
def test_photo_aug_functions_are_bit_equal(name, seed):
    want_rng, got_rng = random.Random(seed), random.Random(seed)
    want = AUG_CALLS[name](jax_aug, want_rng)
    got = AUG_CALLS[name](port_aug, got_rng)
    _assert_equal(got, want)
    assert got_rng.getstate() == want_rng.getstate()  # the same draws


def test_real_textures_are_the_jax_packages():
    want, got = jax_aug._real_textures(), port_aug._real_textures()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
