"""CRAFT text detector (VGG16 backbone with GroupNorm), as torch modules.

Counterpart of ``bbocr_tpu/models/craft.py::CRAFT`` with ``VGG16BN``. The
modules are NCHW; weights come from the flax tree through
``bbocr_tpu_torch.models.convert``. Details that keep parity:

- flax ``GroupNorm`` has eps 1e-6 (torch defaults to 1e-5); groups are
  ``min(32, C)``; in bfloat16 the layers of ``models.layers`` round where
  flax does;
- "SAME" stride-1 convs pad ``dilation * (k - 1) // 2`` on each side; the
  fc6 conv is 3x3 with dilation 6; the fc pool is a 3x3 stride-1 max pool
  padded with -inf;
- ``_upsample_to`` is ``jax.image.resize(..., "bilinear")``, which for
  these upsamples is ``F.interpolate(mode="bilinear", align_corners=False)``;
- ``gray_input=True`` takes one raw-gray plane in [0, 255] and appends a
  ones plane, for the stem that ``fold_gray_stem`` folds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bbocr_tpu_torch.models.layers import Conv2d, GroupNorm

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class ConvBN(nn.Module):
    """Conv ("SAME", stride 1) + optional GroupNorm + ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, dilation: int = 1, use_bn: bool = True):
        super().__init__()
        self.conv = Conv2d(
            cin, cout, kernel, padding=dilation * (kernel - 1) // 2,
            dilation=dilation, bias=not use_bn,
        )
        self.norm = GroupNorm(min(32, cout), cout) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x)


# (in, out) channels of VGG16BN's ConvBN_0..12; indices 13 and 14 are fc6/fc7.
_VGG_CONVS = (
    (3, 64), (64, 64),
    (64, 128), (128, 128),
    (128, 256), (256, 256), (256, 256),
    (256, 512), (512, 512), (512, 512),
    (512, 512), (512, 512), (512, 512),
)


class VGG16BN(nn.Module):
    """Backbone emitting the five skip features CRAFT consumes."""

    def __init__(self, gray_input: bool = False):
        super().__init__()
        self.gray_input = gray_input
        convs = [ConvBN(2 if (i == 0 and gray_input) else cin, cout) for i, (cin, cout) in enumerate(_VGG_CONVS)]
        convs.append(ConvBN(512, 1024, kernel=3, dilation=6, use_bn=False))
        convs.append(ConvBN(1024, 1024, kernel=1, use_bn=False))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor):
        c = self.convs
        if self.gray_input:
            x = torch.cat([x, torch.ones_like(x)], dim=1)
        x = c[1](c[0](x))
        x = F.max_pool2d(x, 2)  # /2
        f1 = c[3](c[2](x))  # 128 @ /2
        x = F.max_pool2d(f1, 2)  # /4
        f2 = c[6](c[5](c[4](x)))  # 256 @ /4
        x = F.max_pool2d(f2, 2)  # /8
        f3 = c[9](c[8](c[7](x)))  # 512 @ /8
        x = F.max_pool2d(f3, 2)  # /16
        f4 = c[12](c[11](c[10](x)))  # 512 @ /16
        x = F.max_pool2d(f4, 3, stride=1, padding=1)
        f5 = c[14](c[13](x))  # 1024 @ /16
        return f1, f2, f3, f4, f5


def _double_conv(cin: int, mid: int, out: int) -> nn.Sequential:
    return nn.Sequential(ConvBN(cin, mid, kernel=1), ConvBN(mid, out, kernel=3))


def _upsample_to(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, size=ref.shape[-2:], mode="bilinear", align_corners=False)


class CRAFT(nn.Module):
    """Input (B, 3, H, W) ImageNet-normalized, or (B, 1, H, W) raw gray in
    [0, 255] with ``gray_input=True``; H, W multiples of 32.

    Output: (B, 2, H/2, W/2) float32 sigmoid scores: channel 0 region,
    channel 1 affinity.
    """

    def __init__(self, gray_input: bool = False):
        super().__init__()
        self.backbone = VGG16BN(gray_input=gray_input)
        self.decoder = nn.ModuleList([
            _double_conv(1536, 512, 256),
            _double_conv(768, 256, 128),
            _double_conv(384, 128, 64),
            _double_conv(192, 64, 32),
        ])
        self.head = nn.ModuleList([
            ConvBN(32, 32, use_bn=False),
            ConvBN(32, 32, use_bn=False),
            ConvBN(32, 16, use_bn=False),
            ConvBN(16, 16, kernel=1, use_bn=False),
        ])
        self.out = Conv2d(16, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f1, f2, f3, f4, f5 = self.backbone(x)
        y = self.decoder[0](torch.cat([f5, f4], dim=1))
        y = self.decoder[1](torch.cat([_upsample_to(y, f3), f3], dim=1))
        y = self.decoder[2](torch.cat([_upsample_to(y, f2), f2], dim=1))
        y = self.decoder[3](torch.cat([_upsample_to(y, f1), f1], dim=1))
        for conv in self.head:
            y = conv(y)
        return torch.sigmoid(self.out(y).float())
