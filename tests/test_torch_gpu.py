"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``gpu`` and skips where no CUDA card is present.
The file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest -p no:cacheprovider
"""

import os

import numpy as np
import pytest
import torch

from bbocr_tpu_torch import kernels, ops
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.preprocess import preprocess_for_book_cover
from bbocr_tpu_torch.preprocess.chain import PLAIN_OPS, _preprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOK1 = os.path.join(ROOT, "data", "real", "covers", "book1.png")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# the slice's shape and its neighbours, odd widths, images smaller than the
# 7-tap halo, and a row pitch that is not 8-byte aligned
SHAPES = [(2, 70, 90), (1, 33, 41), (1, 1312, 1050), (1, 1, 1), (1, 2, 3), (1, 3, 8), (2, 7, 5),
          (1, 1313, 1051), (1, 64, 4099)]


@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernels_match_plain(cuda_device, shape):
    """Bit-exact: the kernels round every operation as the plain versions do."""
    x = torch.from_numpy(np.random.default_rng(8).integers(0, 256, shape).astype(np.float32)).to(cuda_device)
    mean = ops.rounded_mean(x)
    kernels.reset_launches()
    assert torch.equal(kernels.blur3_u8(x), kernels.blur3_u8_plain(x))
    assert torch.equal(kernels.unsharp_u8(x), kernels.unsharp_u8_plain(x))
    assert torch.equal(kernels.enhance_u8(x, mean, 1.9, 1.2), kernels.enhance_u8_plain(x, mean, 1.9, 1.2))
    assert all(fn.launches == 1 for fn in kernels.KERNELS.values())


@pytest.mark.parametrize("percent", [30, 31.5, -200, 70000])
def test_cuda_unsharp_takes_any_percent(cuda_device, percent):
    """Integer percents up to 65793 divide in integers, others in float:
    both bit-exact against the plain version."""
    x = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (1, 97, 300)).astype(np.float32)).to(cuda_device)
    assert torch.equal(kernels.unsharp_u8(x, percent, 0), kernels.unsharp_u8_plain(x, percent, 0))


def test_cuda_kernels_take_an_unaligned_view(cuda_device):
    """A contiguous view 4 bytes past an 8-byte boundary takes the 4-byte path."""
    flat = torch.from_numpy(np.random.default_rng(10).integers(0, 256, 2 * 40 * 64 + 1).astype(np.float32)).to(cuda_device)
    x = flat[1:].view(2, 40, 64)
    assert x.data_ptr() % 8 == 4
    assert torch.equal(kernels.blur3_u8(x), kernels.blur3_u8_plain(x))
    assert torch.equal(kernels.unsharp_u8(x), kernels.unsharp_u8_plain(x))


def test_cuda_chain_matches_plain_chain(cuda_device):
    rgb = load_rgb(BOOK1)
    a, _ = preprocess_for_book_cover(rgb, device=cuda_device)
    b = _preprocess(rgb, 1.5, cuda_device, PLAIN_OPS)
    assert torch.equal(a, b)


def test_cuda_wrapper_rejects_cpu_mean(cuda_device):
    x = torch.zeros((1, 8, 8), device=cuda_device)
    with pytest.raises(ValueError):
        kernels.enhance_u8(x, torch.zeros(1), 1.9, 1.2)
