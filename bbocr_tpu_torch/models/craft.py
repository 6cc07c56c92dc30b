"""CRAFT text detectors, as torch modules.

Counterparts of ``bbocr_tpu/models/craft.py``: ``CRAFT`` (VGG16 backbone
with GroupNorm), the slim ``CRAFTLite`` (``LiteBackbone``) and
``CRAFTPublished``, the published torch dataflow with BatchNorm on running
statistics for imported weights (raw scores, no sigmoid). The modules are
NCHW; weights come from the flax tree through
``bbocr_tpu_torch.models.convert``. Details that keep parity:

- flax ``GroupNorm`` has eps 1e-6 (torch defaults to 1e-5); groups are
  ``min(32, C)``; in bfloat16 the layers of ``models.layers`` round where
  flax does;
- "SAME" stride-1 convs pad ``dilation * (k - 1) // 2`` on each side; the
  fc6 conv is 3x3 with dilation 6; the fc pool is a 3x3 stride-1 max pool
  padded with -inf; ``LiteBackbone``'s stride-2 "SAME" stem pads as XLA
  does, (0, 1) on an even side (``_same_pads``), not torch's (1, 1);
- flax ``BatchNorm`` has eps 1e-5 (``models.layers.BatchNorm``);
- ``_upsample_to`` is ``jax.image.resize(..., "bilinear")``, which for
  these upsamples is ``F.interpolate(mode="bilinear", align_corners=False)``;
- ``gray_input=True`` takes one raw-gray plane in [0, 255] and appends a
  ones plane, for the stem that ``fold_gray_stem`` folds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bbocr_tpu_torch.models.layers import BatchNorm, Conv2d, GroupNorm

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


def _same_pads(size: int, kernel: int, stride: int) -> tuple:
    """XLA's "SAME" padding of one axis: (before, after), the odd pixel after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class LiteBackbone(nn.Module):
    """The slim backbone: a stride-2 stem (the only full-resolution op),
    stages of 32/64/128/256 channels with two ConvBN each, and a dilated
    3x3 at /16. ``gray_input`` as for ``VGG16BN``."""

    def __init__(self, gray_input: bool = False):
        super().__init__()
        self.gray_input = gray_input
        self.stem = Conv2d(2 if gray_input else 3, 32, 3, stride=2, bias=False)
        self.stem_norm = GroupNorm(32, 32)
        chans = (32, 32, 32, 64, 64, 128, 128, 256, 256, 256)
        convs = [ConvBN(a, b) for a, b in zip(chans[:-2], chans[1:-1])]
        convs.append(ConvBN(256, 256, kernel=3, dilation=6))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor):
        c = self.convs
        if self.gray_input:
            x = torch.cat([x, torch.ones_like(x)], dim=1)
        top, bottom = _same_pads(x.shape[-2], 3, 2)
        left, right = _same_pads(x.shape[-1], 3, 2)
        x = F.relu(self.stem_norm(self.stem(F.pad(x, (left, right, top, bottom)))))
        f1 = c[1](c[0](x))  # 32 @ /2
        f2 = c[3](c[2](F.max_pool2d(f1, 2)))  # 64 @ /4
        f3 = c[5](c[4](F.max_pool2d(f2, 2)))  # 128 @ /8
        f4 = c[8](c[7](c[6](F.max_pool2d(f3, 2))))  # 256 @ /16
        return f1, f2, f3, f4


class CRAFTLite(nn.Module):
    """Slim CRAFT with :class:`CRAFT`'s contract (input, sigmoid output) at
    about 1/8 of its operations."""

    def __init__(self, gray_input: bool = False):
        super().__init__()
        self.backbone = LiteBackbone(gray_input=gray_input)
        self.decoder = nn.ModuleList([
            _double_conv(384, 128, 96),
            _double_conv(160, 64, 64),
            _double_conv(96, 64, 32),
        ])
        self.head = nn.ModuleList([ConvBN(32, 16, use_bn=False)])
        self.out = Conv2d(16, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f1, f2, f3, f4 = self.backbone(x)
        y = self.decoder[0](torch.cat([_upsample_to(f4, f3), f3], dim=1))
        y = self.decoder[1](torch.cat([_upsample_to(y, f2), f2], dim=1))
        y = self.decoder[2](torch.cat([_upsample_to(y, f1), f1], dim=1))
        return torch.sigmoid(self.out(self.head[0](y)).float())


class _BNConvSeq(nn.Module):
    """[leading ReLU] then 3x3 Conv (bias) -> BatchNorm, a ReLU between
    them and a 2x2 max pool before conv ``pool_before``; ends before a
    ReLU, like the published slices."""

    def __init__(self, cin: int, features: tuple, pool_before: int = -1, leading_relu: bool = False):
        super().__init__()
        chans = (cin,) + tuple(features)
        self.convs = nn.ModuleList([Conv2d(a, b, 3, padding=1) for a, b in zip(chans, chans[1:])])
        self.norms = nn.ModuleList([BatchNorm(f) for f in features])
        self.pool_before, self.leading_relu = pool_before, leading_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.leading_relu:
            x = F.relu(x)
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            if i == self.pool_before:
                x = F.max_pool2d(x, 2)
            if i > 0:
                x = F.relu(x)
            x = norm(conv(x))
        return x


class _Slice5(nn.Module):
    """fc6/fc7: a 3x3 stride-1 max pool, a dilated 3x3 conv and a 1x1 conv
    of 1024 channels (biases, no BatchNorm, no ReLU)."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList([Conv2d(512, 1024, 3, padding=6, dilation=6), Conv2d(1024, 1024, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs[1](self.convs[0](F.max_pool2d(x, 3, stride=1, padding=1)))


class _DoubleConvBN(nn.Module):
    """The published upconv block: 1x1 -> BN -> ReLU -> 3x3 -> BN -> ReLU."""

    def __init__(self, cin: int, mid: int, out: int):
        super().__init__()
        self.convs = nn.ModuleList([Conv2d(cin, mid, 1), Conv2d(mid, out, 3, padding=1)])
        self.norms = nn.ModuleList([BatchNorm(mid), BatchNorm(out)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, norm in zip(self.convs, self.norms):
            x = F.relu(norm(conv(x)))
        return x


class CRAFTPublished(nn.Module):
    """CRAFT with the published dataflow, for imported weights
    (``models.weights.import_craft_from_torch``): the VGG16-BN backbone
    tapped mid-stage before the ReLU. Input (B, 3, H, W)
    ImageNet-normalized, H, W multiples of 32; output (B, 2, H/2, W/2)
    float32 raw scores (no sigmoid)."""

    def __init__(self):
        super().__init__()
        self.slice1 = _BNConvSeq(3, (64, 64, 128, 128), pool_before=2)  # 128 @ /2
        self.slice2 = _BNConvSeq(128, (256, 256), pool_before=0, leading_relu=True)  # 256 @ /4
        self.slice3 = _BNConvSeq(256, (256, 512, 512), pool_before=1, leading_relu=True)  # 512 @ /8
        self.slice4 = _BNConvSeq(512, (512, 512, 512), pool_before=1, leading_relu=True)  # 512 @ /16
        self.slice5 = _Slice5()  # 1024 @ /16
        self.upconv1 = _DoubleConvBN(1536, 512, 256)
        self.upconv2 = _DoubleConvBN(768, 256, 128)
        self.upconv3 = _DoubleConvBN(384, 128, 64)
        self.upconv4 = _DoubleConvBN(192, 64, 32)
        self.head = nn.ModuleList([
            Conv2d(32, 32, 3, padding=1), Conv2d(32, 32, 3, padding=1), Conv2d(32, 16, 3, padding=1),
            Conv2d(16, 16, 1), Conv2d(16, 2, 1),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s1 = self.slice1(x)
        s2 = self.slice2(s1)
        s3 = self.slice3(s2)
        s4 = self.slice4(s3)
        y = self.upconv1(torch.cat([self.slice5(s4), s4], dim=1))
        y = self.upconv2(torch.cat([_upsample_to(y, s3), s3], dim=1))
        y = self.upconv3(torch.cat([_upsample_to(y, s2), s2], dim=1))
        y = self.upconv4(torch.cat([_upsample_to(y, s1), s1], dim=1))
        for conv in self.head[:-1]:
            y = F.relu(conv(y))
        return self.head[-1](y).float()
