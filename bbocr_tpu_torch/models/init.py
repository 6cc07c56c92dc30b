"""flax's initialisers, drawn from a ``torch.Generator``.

Fresh (untrained) parameters for ``OCREngine.create`` and the trainer, as
flax trees with flax's keys, shapes and dtypes (float32). The values follow
flax's rules but not ``jax.random``'s stream:

- conv and ``Dense`` kernels (and ``MultiHeadDotProductAttention``'s
  ``DenseGeneral`` kernels, flattened as flax flattens them): ``lecun_normal``,
  a normal truncated at two deviations, scaled by ``sqrt(1 / fan_in) /
  .87962566103423978`` so that the truncated draw has variance ``1 / fan_in``;
  ``fan_in`` is the receptive field times the input channels;
- the LSTM's ``w_ih``: ``lecun_normal`` over its (C, 4H) layout; ``w_hh``:
  ``orthogonal`` (orthonormal rows); ``b_ih``: zeros with the forget-gate
  quarter set to 1 (``bbocr_tpu/models/crnn.py::_lstm_bias_init``);
- ``nn.Embed``: a normal of deviation ``sqrt(1 / features)``;
- biases zeros; GroupNorm and LayerNorm scales ones, biases zeros.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from bbocr_tpu_torch.models.convert import craft_params, crnn_params, pagereader_params
from bbocr_tpu_torch.models.craft import CRAFT, CRAFTLite
from bbocr_tpu_torch.models.crnn import CRNN, LSTMScan
from bbocr_tpu_torch.models.layers import BatchNorm

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling constant)
_TRUNC_STD = 0.87962566103423978


def _generator(seed_or_generator) -> torch.Generator:
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    g = torch.Generator()
    g.manual_seed(int(seed_or_generator))
    return g


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def lstm_bias_(t: torch.Tensor) -> torch.Tensor:
    """Zeros with the forget-gate quarter set to 1 (gates: i, f, g, o)."""
    h = t.shape[0] // 4
    with torch.no_grad():
        t.zero_()
        t[h : 2 * h] = 1.0
    return t


@torch.no_grad()
def init_module_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter of ``module`` (a port model) as flax
    initialises its counterpart, in module order."""
    for sub in module.modules():
        if isinstance(sub, LSTMScan):
            lecun_normal_(sub.w_ih, sub.w_ih.shape[0], generator)
            lstm_bias_(sub.b_ih)
            nn.init.orthogonal_(sub.w_hh, generator=generator)
        elif isinstance(sub, nn.Conv2d):
            lecun_normal_(sub.weight, sub.weight[0].numel(), generator)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, nn.Linear):
            lecun_normal_(sub.weight, sub.weight.shape[1], generator)
            sub.bias.zero_()
        elif isinstance(sub, nn.Embedding):
            nn.init.normal_(sub.weight, 0.0, math.sqrt(1.0 / sub.weight.shape[1]), generator=generator)
        elif isinstance(sub, (nn.GroupNorm, BatchNorm)) or type(sub).__name__ == "LayerNorm":
            sub.weight.fill_(1.0)
            sub.bias.zero_()
    return module


def init_craft(seed_or_generator=0, lite: bool = False) -> Dict[str, Any]:
    """A fresh ``CRAFT`` (or ``CRAFTLite``) flax tree, RGB stem."""
    model = CRAFTLite() if lite else CRAFT()
    return craft_params(init_module_(model, _generator(seed_or_generator)).state_dict())


def init_crnn(seed_or_generator=0, num_classes: int = 97) -> Dict[str, Any]:
    """A fresh ``CRNN(norm="group")`` flax tree."""
    model = CRNN(num_classes=num_classes)
    return crnn_params(init_module_(model, _generator(seed_or_generator)).state_dict())


def init_pagereader(seed_or_generator=0, with_ctc: bool = False, heads: int = 6, patch: int = 8,
                    **dims) -> Dict[str, Any]:
    """A fresh ``PageReader`` flax tree; ``ctc_head`` only ``with_ctc``, as
    flax materialises it only when ``init`` is called with ``with_ctc=True``."""
    from bbocr_tpu_torch.models.vlm import PageReader

    model = init_module_(PageReader(heads=heads, patch=patch, **dims), _generator(seed_or_generator))
    sd = {k: v for k, v in model.state_dict().items() if with_ctc or not k.startswith("ctc_head.")}
    return pagereader_params(sd, heads=heads, patch=patch)


def init_engine_params(seed: int = 0, num_classes: int = 97):
    """(craft_tree, crnn_tree) of fresh parameters, as ``OCREngine.create``
    and ``create_train_state`` make them: one generator, CRAFT first."""
    g = _generator(seed)
    return init_craft(g), init_crnn(g, num_classes)
