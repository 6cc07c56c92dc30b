"""CRNN recognizer (VGG features -> two BiLSTMs -> CTC head), torch modules.

Counterpart of ``bbocr_tpu/models/crnn.py::CRNN`` with ``norm="group"``.
A 32-px-high gray crop collapses to T = W/4 - 1 frames of 256 features.
The forward follows the JAX engine's compiled recognizer where its
arithmetic is known (``models/layers.py``): products summed in XLA's
order, conv -> GroupNorm normalised as XLA fuses them, logits unrounded
after the head's bias.
The LSTMs are ``LSTMScan``, the JAX package's per-step scan written out in
plain PyTorch ops (the JAX side is a ``lax.scan`` in XLA, not a Pallas
kernel): gates in the order i, f, g, o, one bias, and the backward
direction runs over the whole padded width, as the flipped scan does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bbocr_tpu_torch.models.layers import Conv2d, GroupNorm, Linear, conv2d_xla_order, dot_xla_order, group_norm_of_conv

INPUT_HEIGHT = 32  # recognizer crop height, fixed by the architecture


class VGGFeatures(nn.Module):
    """(B, 1, 32, W) -> (B, T=W/4-1, out) sequence features."""

    def __init__(self, out: int = 256):
        super().__init__()
        oc = [out // 8, out // 4, out // 2, out]
        self.convs = nn.ModuleList([
            Conv2d(1, oc[0], 3, padding=1),
            Conv2d(oc[0], oc[1], 3, padding=1),
            Conv2d(oc[1], oc[2], 3, padding=1),
            Conv2d(oc[2], oc[2], 3, padding=1),
            Conv2d(oc[2], oc[3], 3, padding=1, bias=False),
            Conv2d(oc[3], oc[3], 3, padding=1, bias=False),
            Conv2d(oc[3], oc[3], 2),
        ])
        self.norms = nn.ModuleList([GroupNorm(32, oc[3]) for _ in range(2)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype

        def conv(x, layer):  # rounded product, then the bias: flax's two roundings
            y = conv2d_xla_order(x, layer.weight, layer.padding[0]).to(dt)
            return y + layer.bias[:, None, None]

        def conv_norm(x, layer, norm):
            return group_norm_of_conv(conv2d_xla_order(x, layer.weight, layer.padding[0]), norm, dt)

        c = self.convs
        x = F.max_pool2d(F.relu(conv(x, c[0])), 2)  # 16 x W/2
        x = F.max_pool2d(F.relu(conv(x, c[1])), 2)  # 8 x W/4
        x = F.relu(conv(F.relu(conv(x, c[2])), c[3]))
        x = F.max_pool2d(x, (2, 1))  # 4 x W/4
        x = F.relu(conv_norm(x, c[4], self.norms[0]))
        x = F.relu(conv_norm(x, c[5], self.norms[1]))
        x = F.max_pool2d(x, (2, 1))  # 2 x W/4
        x = F.relu(conv(x, c[6]))  # (B, C, 1, W/4 - 1)
        return x[:, :, 0, :].transpose(1, 2)  # (B, T, C)


class LSTMScan(nn.Module):
    """One direction's LSTM parameters in the JAX layout: ``w_ih`` (C, 4H),
    ``b_ih`` (4H), ``w_hh`` (H, 4H). ``BiLSTM`` runs both directions in one
    step loop (``bidirectional_scan``)."""

    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.zeros(cin, 4 * hidden))
        self.b_ih = nn.Parameter(torch.zeros(4 * hidden))
        self.w_hh = nn.Parameter(torch.zeros(hidden, 4 * hidden))


def _sigmoid(v: torch.Tensor) -> torch.Tensor:
    # 1 / (1 + exp(-v)), each op rounded to v's type, as XLA expands it
    return torch.reciprocal(torch.exp(torch.neg(v)).add_(1.0))


def bidirectional_scan(x: torch.Tensor, fwd: LSTMScan, bwd: LSTMScan) -> torch.Tensor:
    """(B, T, C) -> (B, T, 2H): ``LSTMScan`` forward and reversed, concatenated.

    Every op runs in the parameters' type and rounds where flax's bfloat16
    ``LSTMScan`` does: ``xz = (x @ w_ih) + b_ih`` with two roundings, then
    per step ``z = xz_t + (h @ w_hh)``, sigmoid as 1 / (1 + exp(-z)), and
    ``c = f*c + i*g``, ``h = o * tanh(c)`` with every product and sum
    rounded. The matrix products take float32 operands (exact for bfloat16
    values) and round once, as XLA's CPU dot does (``dot_xla_order``); in
    float32 nothing extra is rounded. The two directions share the loop: the
    backward one's inputs are flipped in time and stacked behind the
    forward one's, so each step is one batched product for both.
    """
    b, t, c_in = x.shape
    dt = fwd.w_ih.dtype
    hidden = fwd.w_hh.shape[0]
    x = x.to(dt).float().reshape(b * t, c_in)
    xz = torch.stack([dot_xla_order(x, d.w_ih.float()).to(dt).add_(d.b_ih).view(b, t, -1) for d in (fwd, bwd)])
    xz = torch.stack([xz[0], xz[1].flip(1)]).transpose(1, 2).contiguous()  # (2, T, B, 4H), time-major
    w_hh = torch.stack([fwd.w_hh, bwd.w_hh]).float()  # (2, H, 4H)
    h = xz.new_zeros((2, b, hidden))
    c = torch.zeros_like(h)
    ys = xz.new_empty((2, t, b, hidden))
    for step in range(t):
        z = dot_xla_order(h.float(), w_hh).to(dt).add_(xz[:, step])
        gates = _sigmoid(z)
        i, f, o = gates[..., :hidden], gates[..., hidden : 2 * hidden], gates[..., 3 * hidden :]
        g = torch.tanh(z[..., 2 * hidden : 3 * hidden])
        c = torch.mul(f, c).add_(torch.mul(i, g))
        h = torch.mul(o, torch.tanh(c))
        ys[:, step] = h
    return torch.cat([ys[0], ys[1].flip(0)], dim=-1).transpose(0, 1)  # (B, T, 2H)


class BiLSTM(nn.Module):
    """Bidirectional LSTM + linear merge (the published BidirectionalLSTM)."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__()
        self.fwd = LSTMScan(cin, hidden)
        self.bwd = LSTMScan(cin, hidden)
        self.proj = Linear(2 * hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(bidirectional_scan(x, self.fwd, self.bwd))


class CRNN(nn.Module):
    """(B, 1, 32, W) grayscale in [-1, 1] -> (B, T, num_classes) float32 logits."""

    def __init__(self, num_classes: int, hidden: int = 256, features: int = 256):
        super().__init__()
        self.features = VGGFeatures(features)
        self.rnn0 = BiLSTM(features, hidden, hidden)
        self.rnn1 = BiLSTM(hidden, hidden, hidden)
        self.head = Linear(hidden, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = self.rnn1(self.rnn0(self.features(x)))
        # the logits leave the model unrounded after the bias, as the JAX
        # engine's compiled program keeps them (its cast to float32 follows)
        return self.head.product(seq).to(seq.dtype).float() + self.head.bias.float()
