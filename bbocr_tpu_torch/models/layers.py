"""Layers that round low-precision activations where flax does.

flax computes a layer built with ``dtype=jnp.bfloat16`` as follows, and the
port's bfloat16 forward follows it:

- ``nn.GroupNorm`` keeps float32 ``scale`` and ``bias`` (``param_dtype``),
  normalises in float32 and rounds to bfloat16 once, at the end;
- ``nn.Conv`` and ``nn.Dense`` round the product to bfloat16 and then add
  the bfloat16 bias (``y += bias``): two roundings, where ``nn.Conv2d``
  adds the bias inside its float32 accumulator and rounds once.

In float32 these layers compute exactly what their ``torch.nn`` bases do.
``cast_for_compute`` casts a model to the compute type and leaves the
GroupNorm parameters in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

GROUPNORM_EPS = 1e-6  # flax.linen.GroupNorm's default


class GroupNorm(nn.GroupNorm):
    """GroupNorm with flax's eps; float32 statistics and affine parameters,
    one rounding to the input's type."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__(num_groups, num_channels, eps=GROUPNORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The input is cast because PyTorch's CUDA group_norm refuses a
        # bfloat16 input with float32 parameters (its CPU one accepts it).
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps).to(x.dtype)


class Conv2d(nn.Conv2d):
    """Conv2d whose bias, outside float32, is added to the rounded product."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None or x.dtype == torch.float32:
            return super().forward(x)
        return self._conv_forward(x, self.weight, None) + self.bias[:, None, None]


class Linear(nn.Linear):
    """Linear whose bias, outside float32, is added to the rounded product."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None or x.dtype == torch.float32:
            return super().forward(x)
        return F.linear(x, self.weight) + self.bias


def cast_for_compute(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast ``model``'s parameters to ``dtype``, GroupNorm's excepted."""
    for module in model.modules():
        if not isinstance(module, nn.GroupNorm):
            module._apply(lambda t: t.to(dtype) if t.is_floating_point() else t, recurse=False)
    return model
