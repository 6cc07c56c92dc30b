"""The preprocessing kernels: wrappers, launch counts and plain versions.

Each public function takes an (N, H, W) float32 contiguous tensor holding
uint8 values and returns one like it. For a CUDA tensor it launches its
hand-written kernel (``csrc/preprocess.cu``) on the current stream and adds
one to its ``launches`` count; for a CPU tensor it returns its plain
PyTorch version, which the kernel matches bit for bit. It never falls back
from a failed launch.

=====================  =========================================  ==========
function               replaces (bbocr_tpu/kernels/               bound
                       preprocess_pallas.py)
=====================  =========================================  ==========
``blur3_u8``           ``blur3_u8_pallas`` via ``_run_sepconv``   bytes
``unsharp_u8``         ``unsharp_u8_pallas`` via ``_run_sepconv`` bytes
``enhance_u8``         ``enhance_u8_pallas`` / ``_enhance_kernel`` bytes
=====================  =========================================  ==========

Each is bound by one read and one write of the image: 2 * N*H*W*4 bytes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bbocr_tpu_torch.kernels import build
from bbocr_tpu_torch.ops.filters import (
    gaussian_blur,
    gaussian_kernel_1d,
    pil_gaussian_kernel_1d,
    unsharp_mask,
)
from bbocr_tpu_torch.ops.pil_enhance import _blend


def _check_image(img: torch.Tensor) -> None:
    if img.dtype != torch.float32 or img.ndim != 3:
        raise ValueError(f"expected an (N, H, W) float32 tensor, got {tuple(img.shape)} {img.dtype}")
    if not img.is_contiguous():
        raise ValueError("expected a contiguous tensor")
    n, h, w = img.shape
    if min(n, h, w) < 1 or n > 65535 or h * w >= 2**31:
        raise ValueError(f"unsupported image stack shape {tuple(img.shape)}")
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {img.device}")


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    """The bound C launcher ``bbocr_<name>``, built and loaded on first use."""
    return getattr(build.load(), f"bbocr_{name}")


@functools.lru_cache(maxsize=None)
def _blur3_taps(sigma: float) -> ctypes.Array:
    return _taps(gaussian_kernel_1d(3, sigma))


@functools.lru_cache(maxsize=None)
def _unsharp_taps(radius: float) -> ctypes.Array:
    taps = pil_gaussian_kernel_1d(radius)
    if len(taps) != 7:
        raise ValueError(f"the kernel takes a 7-tap blur; radius {radius} gives {len(taps)}")
    return _taps(taps)


def _taps(values) -> ctypes.Array:
    return (ctypes.c_float * len(values))(*values)


def _launch(fn, img: torch.Tensor, *args) -> None:
    """Call the launcher ``bbocr_<fn.__name__>`` with ``args`` and the
    image's current stream, with the image's card current; count the launch
    once it has succeeded."""
    launcher = _launcher(fn.__name__)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    if img.device.index == torch.cuda.current_device():
        err = launcher(*args, stream)
    else:
        with torch.cuda.device(img.device):
            err = launcher(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    fn.launches += 1


def blur3_u8_plain(img: torch.Tensor, sigma: float = 3.0) -> torch.Tensor:
    """cv2.GaussianBlur((3, 3), sigma), REFLECT_101, + uint8 store."""
    return gaussian_blur(img, 3, sigma)


def blur3_u8(img: torch.Tensor, sigma: float = 3.0) -> torch.Tensor:
    """cv2.GaussianBlur((3, 3), sigma) + uint8 store, (N, H, W) float32."""
    _check_image(img)
    if img.device.type == "cpu":
        return blur3_u8_plain(img, sigma)
    n, h, w = img.shape
    out = torch.empty_like(img)
    _launch(blur3_u8, img, img.data_ptr(), out.data_ptr(), n, h, w, _blur3_taps(float(sigma)))
    return out


def unsharp_u8_plain(img: torch.Tensor, percent: int = 30, threshold: int = 3, radius: float = 1.0) -> torch.Tensor:
    """PIL UnsharpMask(radius, percent, threshold), edge border."""
    return unsharp_mask(img, radius, percent, threshold)


def unsharp_u8(img: torch.Tensor, percent: int = 30, threshold: int = 3, radius: float = 1.0) -> torch.Tensor:
    """PIL UnsharpMask: blur, then sharpen where |src - blur| >= threshold."""
    _check_image(img)
    taps = _unsharp_taps(float(radius))
    if img.device.type == "cpu":
        return unsharp_u8_plain(img, percent, threshold, radius)
    n, h, w = img.shape
    out = torch.empty_like(img)
    _launch(unsharp_u8, img, img.data_ptr(), out.data_ptr(), n, h, w, taps, float(percent), float(threshold))
    return out


def enhance_u8_plain(img: torch.Tensor, mean: torch.Tensor, contrast: float, brightness: float) -> torch.Tensor:
    """PIL Contrast(contrast) then Brightness(brightness); ``mean``: (N,)."""
    y = _blend(mean[:, None, None], img, contrast)
    return _blend(torch.zeros_like(y), y, brightness)


def enhance_u8(img: torch.Tensor, mean: torch.Tensor, contrast: float, brightness: float) -> torch.Tensor:
    """Fused PIL Contrast + Brightness; ``mean``: (N,) float32 rounded means."""
    _check_image(img)
    if mean.shape != (img.shape[0],) or mean.dtype != torch.float32 or mean.device != img.device:
        raise ValueError("mean must be an (N,) float32 tensor on the image's device")
    if img.device.type == "cpu":
        return enhance_u8_plain(img, mean, contrast, brightness)
    n, h, w = img.shape
    mean = mean.contiguous()
    out = torch.empty_like(img)
    _launch(enhance_u8, img, img.data_ptr(), mean.data_ptr(), out.data_ptr(), n, h, w, float(contrast), float(brightness))
    return out


for _fn in (blur3_u8, unsharp_u8, enhance_u8):
    _fn.launches = 0

KERNELS = {"blur3_u8": blur3_u8, "enhance_u8": enhance_u8, "unsharp_u8": unsharp_u8}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
