"""CRNN recognizer (VGG features -> two BiLSTMs -> CTC head), torch modules.

Counterpart of ``bbocr_tpu/models/crnn.py::CRNN`` with ``norm="group"``.
A 32-px-high gray crop collapses to T = W/4 - 1 frames of 256 features.
The LSTMs are ``nn.LSTM`` (the JAX side is a ``lax.scan`` in XLA, not a
Pallas kernel): gates in the order i, f, g, o, one bias (``bias_hh`` is
zero), and the backward direction runs over the whole padded width, as the
flipped scan does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bbocr_tpu_torch.models.layers import Conv2d, GroupNorm, Linear

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
        c = self.convs
        x = F.max_pool2d(F.relu(c[0](x)), 2)  # 16 x W/2
        x = F.max_pool2d(F.relu(c[1](x)), 2)  # 8 x W/4
        x = F.relu(c[3](F.relu(c[2](x))))
        x = F.max_pool2d(x, (2, 1))  # 4 x W/4
        x = F.relu(self.norms[0](c[4](x)))
        x = F.relu(self.norms[1](c[5](x)))
        x = F.max_pool2d(x, (2, 1))  # 2 x W/4
        x = F.relu(c[6](x))  # (B, C, 1, W/4 - 1)
        return x[:, :, 0, :].transpose(1, 2)  # (B, T, C)


class BiLSTM(nn.Module):
    """Bidirectional LSTM + linear merge (the published BidirectionalLSTM)."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__()
        self.lstm = nn.LSTM(cin, hidden, batch_first=True, bidirectional=True)
        self.proj = Linear(2 * hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, _ = self.lstm(x)
        return self.proj(y)


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
        return self.head(seq).float()
