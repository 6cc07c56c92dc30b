"""Layers that round low-precision activations where flax does.

flax computes a layer built with ``dtype=jnp.bfloat16`` as follows, and the
port's bfloat16 forward follows it:

- ``nn.GroupNorm`` keeps float32 ``scale`` and ``bias`` (``param_dtype``),
  normalises in float32 and rounds to bfloat16 once, at the end;
  ``nn.BatchNorm(use_running_average=True)`` likewise, on its float32
  running statistics;
- ``nn.Conv`` and ``nn.Dense`` round the product to bfloat16 and then add
  the bfloat16 bias (``y += bias``): two roundings, where ``nn.Conv2d``
  adds the bias inside its float32 accumulator and rounds once.

The recognizer (``models/crnn.py``) goes further and follows the JAX
engine's compiled program: its products sum in XLA's order
(``dot_xla_order``, ``conv2d_xla_order``) and its conv -> GroupNorm pairs
are normalised as XLA fuses them (``group_norm_of_conv``).

In float32 these layers compute exactly what their ``torch.nn`` bases do.
``cast_for_compute`` casts a model to the compute type and leaves the
parameters and statistics of the normalisations in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

GROUPNORM_EPS = 1e-6  # flax.linen.GroupNorm's default
BATCHNORM_EPS = 1e-5  # flax.linen.BatchNorm's default


class GroupNorm(nn.GroupNorm):
    """GroupNorm with flax's eps; float32 statistics and affine parameters,
    one rounding to the input's type."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__(num_groups, num_channels, eps=GROUPNORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The input is cast because PyTorch's CUDA group_norm refuses a
        # bfloat16 input with float32 parameters (its CPU one accepts it).
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps).to(x.dtype)


class BatchNorm(nn.Module):
    """Inference BatchNorm on running statistics, as flax's
    ``nn.BatchNorm(use_running_average=True)`` computes it
    (``flax.linen.normalization._normalize``): in float32,
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, rounded once to the
    input's type. ``weight`` and ``bias`` are flax's ``scale`` and ``bias``,
    the buffers its ``batch_stats``."""

    def __init__(self, num_features: int):
        super().__init__()
        self.eps = BATCHNORM_EPS
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


class Conv2d(nn.Conv2d):
    """Conv2d whose bias, outside float32, is added to the rounded product."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None or x.dtype == torch.float32:
            return super().forward(x)
        return self._conv_forward(x, self.weight, None) + self.bias[:, None, None]


class Linear(nn.Linear):
    """Linear whose bias, outside float32, is added to the rounded product;
    the product sums float32 operands in the order of XLA's CPU dot
    (``dot_xla_order``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None or x.dtype == torch.float32:
            return super().forward(x)
        return self.product(x).to(x.dtype) + self.bias

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ W.T`` in float32, unrounded."""
        flat = x.float().reshape(-1, x.shape[-1])
        return dot_xla_order(flat, self.weight.float().T).reshape(*x.shape[:-1], -1)


# XLA's CPU dot, which the JAX package runs, sums the K axis in blocks of
# 128 (block sums added in order) for 2 to 50 rows, and in one sequential
# pass otherwise (measured at the CRNN's K = 256 and 512). Summed the same
# way, the LSTM scan equals the JAX package's bit for bit on the CPU; on an
# H100, cuBLAS's float32 products gave the CPU's scan outputs bit for bit on
# a photo's LSTM calls (chip_smoke.py phase 4 compares them).
_BLOCK_K = 128
_BLOCKED_ROWS = range(2, 51)


def dot_xla_order(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` on float32 operands, summed in the order of XLA's CPU dot
    over ``a``'s rows (its second-to-last axis). bfloat16 products are
    exact in float32, so for bfloat16 values only the order matters."""
    k = a.shape[-1]
    if a.shape[-2] not in _BLOCKED_ROWS or k <= _BLOCK_K:
        return torch.matmul(a, w)
    out = torch.matmul(a[..., :_BLOCK_K], w[..., :_BLOCK_K, :])
    for k0 in range(_BLOCK_K, k, _BLOCK_K):
        out.add_(torch.matmul(a[..., k0 : k0 + _BLOCK_K], w[..., k0 : k0 + _BLOCK_K, :]))
    return out


def _conv_k_blocks(k: int) -> int:
    # XLA's CPU convolution (Eigen) splits a long K axis into equal blocks
    # of at most 320 taps (measured: 1024 -> 4 x 256, 1152 -> 4 x 288,
    # 2304 -> 8 x 288); up to 576 it is one pass
    return 1 if k <= 576 else -(-k // 320)


def conv2d_xla_order(x: torch.Tensor, weight: torch.Tensor, padding: int) -> torch.Tensor:
    """Stride-1 convolution of (B, C, H, W) by (O, C, kh, kw), unrounded
    float32 out: the products of the operands' values summed in float32 in
    the order of XLA's CPU convolution (taps in (kh, kw, c) order, long K
    axes in blocks)."""
    o, c, kh, kw = weight.shape
    xp = F.pad(x.float(), (padding,) * 4)
    b, _, hp, wp = xp.shape
    h, w = hp - kh + 1, wp - kw + 1
    cols = torch.stack([xp[:, :, i : i + h, j : j + w] for i in range(kh) for j in range(kw)], dim=-1)  # (B, C, H, W, taps)
    a = cols.permute(0, 2, 3, 4, 1).reshape(b * h * w, kh * kw * c)
    wm = weight.float().permute(2, 3, 1, 0).reshape(kh * kw * c, o)
    k = kh * kw * c
    step = -(-k // _conv_k_blocks(k))
    out = torch.matmul(a[:, :step], wm[:step])
    for k0 in range(step, k, step):
        out.add_(torch.matmul(a[:, k0 : k0 + step], wm[k0 : k0 + step]))
    return out.reshape(b, h, w, o).permute(0, 3, 1, 2)


def group_norm_of_conv(y: torch.Tensor, norm: nn.GroupNorm, dtype: torch.dtype) -> torch.Tensor:
    """GroupNorm of an unrounded float32 conv output ``y`` (B, C, H, W) as
    XLA compiles flax's conv -> GroupNorm in the JAX engine: the statistics
    come from the conv output rounded to ``dtype``, the unrounded output is
    normalised (mean and mean of squares, variance ``E[x^2] - E[x]^2``,
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``), rounded once."""
    b, c = y.shape[:2]
    g = norm.num_groups
    stats = y.to(dtype).float().reshape(b, g, -1)
    mean = stats.mean(dim=-1)
    var = torch.clamp((stats * stats).mean(dim=-1) - mean * mean, min=0.0)
    mul = (torch.rsqrt(var + norm.eps)[:, :, None] * norm.weight.reshape(g, -1)).reshape(b, c, 1, 1)
    shift = mean.repeat_interleave(c // g, dim=1)[:, :, None, None]
    return ((y - shift) * mul + norm.bias[None, :, None, None]).to(dtype)


def cast_for_compute(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast ``model``'s parameters to ``dtype``, the normalisations' excepted."""
    for module in model.modules():
        if not isinstance(module, (nn.GroupNorm, BatchNorm)):
            module._apply(lambda t: t.to(dtype) if t.is_floating_point() else t, recurse=False)
    return model
