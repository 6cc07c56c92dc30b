"""The port's preprocessing kernels and ops against the JAX package.

The plain PyTorch versions of the three kernels are held bit-exact against
the Pallas kernels (interpret mode on the CPU, as tests/test_kernels.py
runs them), and the ops and the whole chain against their JAX
counterparts. The CUDA kernels themselves are held against the plain
versions in tests/test_torch_gpu.py.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bbocr_tpu import ops as jops
from bbocr_tpu.kernels import blur3_u8_pallas, enhance_u8_pallas, unsharp_u8_pallas
from bbocr_tpu.preprocess.chain import _chain_gray_pallas
from bbocr_tpu_torch import kernels, ops
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.preprocess import preprocess_for_book_cover
from bbocr_tpu_torch.preprocess.chain import PLAIN_OPS, _preprocess

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOK1 = os.path.join(ROOT, "data", "real", "covers", "book1.png")
SHAPES = [(2, 70, 90), (1, 33, 41)]  # tests/test_kernels.py's shapes
# images narrower or shorter than the 7-tap halo, odd widths
TINY_SHAPES = [(1, 1, 1), (1, 2, 3), (1, 3, 8), (2, 7, 5)]


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)


# Bit-exact: the plain versions are what the CUDA kernels are held to, and
# they must equal the Pallas kernels exactly (uint8 values, no tolerance).
@pytest.mark.parametrize("shape", SHAPES + TINY_SHAPES)
def test_blur3_plain_matches_pallas(shape):
    x = _u8(shape, 0)
    ref = np.asarray(blur3_u8_pallas(jnp.asarray(x), 3.0))
    got = kernels.blur3_u8(torch.from_numpy(x), 3.0).numpy()
    np.testing.assert_array_equal(got, ref)


def test_blur3_plain_is_xla_blur_where_pallas_interpret_parts():
    """Pins a known disagreement (ROADMAP Queue 3): on this image the
    interpret-mode Pallas blur3 puts a few pixels whose sum sits on a .5 tie
    on the other side of the rounding, by one level. The plain version,
    which the CUDA kernel equals, is ``bbocr_tpu.ops.gaussian_blur`` bit for
    bit. Should either side change, this test says so."""
    x = _u8((1, 64, 4099), 0)
    got = kernels.blur3_u8(torch.from_numpy(x), 3.0).numpy()
    xla = np.asarray(jops.gaussian_blur(jnp.asarray(x), 3, 3.0))
    np.testing.assert_array_equal(got, xla)
    pallas = np.asarray(blur3_u8_pallas(jnp.asarray(x), 3.0))
    parts = got != pallas
    assert parts.any()
    assert np.abs(got - pallas).max() == 1.0
    unrounded = np.asarray(jops.gaussian_blur(jnp.asarray(x), 3, 3.0, quantize=False))[parts]
    assert np.abs(unrounded - np.floor(unrounded) - 0.5).max() <= 1e-4


@pytest.mark.parametrize("shape", SHAPES + TINY_SHAPES)
def test_unsharp_plain_matches_pallas(shape):
    x = _u8(shape, 1)
    ref = np.asarray(unsharp_u8_pallas(jnp.asarray(x), 30, 3, 1.0))
    got = kernels.unsharp_u8(torch.from_numpy(x), 30, 3, 1.0).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", SHAPES + TINY_SHAPES)
def test_enhance_plain_matches_pallas(shape):
    x = _u8(shape, 2)
    jmean = jnp.floor(jnp.mean(jnp.asarray(x), axis=(1, 2)) + 0.5)
    mean = ops.rounded_mean(torch.from_numpy(x))
    # a float32 mean of these few pixels is exact, so both means agree
    np.testing.assert_array_equal(mean.numpy(), np.asarray(jmean))
    ref = np.asarray(enhance_u8_pallas(jnp.asarray(x), jmean, 1.9, 1.2))
    got = kernels.enhance_u8(torch.from_numpy(x), mean, 1.9, 1.2).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(1, 1312, 1050), (1, 255, 255), (2, 3, 70000)])
def test_rounded_mean_is_exact(shape):
    """The float32 row sums (in column chunks past 65,793 columns) and the
    float64 total equal an int64 sum: PIL's integer mean, to the last bit."""
    x = torch.from_numpy(_u8(shape, 9))
    x[0, 0] = 255.0  # the largest partial sums
    total = x.to(torch.int64).sum(dim=(-2, -1)).to(torch.float64)
    ref = torch.floor(total / (shape[1] * shape[2]) + 0.5).to(torch.float32)
    assert torch.equal(ops.rounded_mean(x), ref)
    assert torch.equal(ops.rounded_mean(torch.full(shape, 255.0)), torch.full(shape[:1], 255.0))


@pytest.mark.parametrize("shape", SHAPES)
def test_clahe_matches_jax(shape):
    x = _u8(shape, 3)
    ref = np.asarray(jops.clahe(jnp.asarray(x), 2.5, (8, 8)))
    np.testing.assert_array_equal(ops.clahe(torch.from_numpy(x), 2.5, (8, 8)).numpy(), ref)


def test_clahe_matches_jax_on_a_cover():
    gray = load_rgb(BOOK1)[..., 1].astype(np.float32)
    ref = np.asarray(jops.clahe(jnp.asarray(gray), 2.5, (8, 8)))
    np.testing.assert_array_equal(ops.clahe(torch.from_numpy(gray), 2.5, (8, 8)).numpy(), ref)


def test_rgb_to_grayscale_matches_jax():
    rgb = _u8((2, 21, 37, 3), 4)
    ref = np.asarray(jops.rgb_to_grayscale(jnp.asarray(rgb)))
    np.testing.assert_array_equal(ops.rgb_to_grayscale(torch.from_numpy(rgb)).numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_resize_bicubic_matches_jax(shape):
    x = _u8(shape, 5)
    oh, ow = int(shape[1] * 1.5), int(shape[2] * 1.5)
    ref = np.asarray(jops.resize_bicubic(jnp.asarray(x), oh, ow))
    np.testing.assert_array_equal(ops.resize_bicubic(torch.from_numpy(x), oh, ow).numpy(), ref)


def test_chain_matches_pallas_chain_on_book1():
    """The whole chain against ``_chain_gray_pallas`` on a real cover.

    Tolerance: at most 0.1 % of pixels may differ. The bicubic resize is a
    float32 matrix product whose sums XLA and PyTorch take in different
    orders, so a few pixels land on the other side of a .5 rounding; the
    rest of the chain is bit-exact (tests above), and the differences only
    travel through the local filters. The mean for the contrast step comes
    from an exact integer sum here and a float32 sum in JAX; on this image
    they agree.
    """
    rgb = load_rgb(BOOK1)
    gray = jops.rgb_to_grayscale(jnp.asarray(rgb, jnp.float32))
    ref = np.asarray(_chain_gray_pallas(gray, 1312, 1050))
    got, steps = preprocess_for_book_cover(rgb, device="cpu")
    assert got.shape == (1312, 1050) and len(steps) == 8
    assert np.mean(got.numpy() != ref) <= 1e-3


def test_chain_without_kernels_is_identical_on_cpu():
    x = _u8((45, 38), 6)
    a, _ = preprocess_for_book_cover(x, device="cpu")
    b = _preprocess(x, 1.5, "cpu", PLAIN_OPS)
    assert torch.equal(a, b)


def test_cpu_wrappers_do_not_launch():
    kernels.reset_launches()
    x = torch.from_numpy(_u8((1, 16, 16), 7))
    kernels.blur3_u8(x)
    kernels.unsharp_u8(x)
    kernels.enhance_u8(x, ops.rounded_mean(x), 1.9, 1.2)
    assert all(fn.launches == 0 for fn in kernels.KERNELS.values())


@pytest.mark.parametrize(
    "bad",
    [
        torch.zeros((16, 16)),
        torch.zeros((1, 16, 16), dtype=torch.float64),
        torch.zeros((1, 16, 32))[:, :, ::2],
    ],
    ids=["2d", "float64", "strided"],
)
def test_wrappers_reject_bad_input(bad):
    with pytest.raises(ValueError):
        kernels.blur3_u8(bad)


def test_enhance_rejects_bad_mean():
    x = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError):
        kernels.enhance_u8(x, torch.zeros(3), 1.9, 1.2)
