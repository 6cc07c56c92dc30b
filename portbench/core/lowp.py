"""Operand rounding for the references and their controls.

A reference takes a ``q`` and applies it to both operands of every product
(convolution, matrix product, attention). ``exact`` is float32 as it is;
``fp8`` rounds an operand to float8 e4m3 with one scale per tensor (its
largest magnitude at 448), as an fp8 product on the card takes its inputs
before it sums them in float32: the control a step below the bfloat16
that the configurations state.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    amax = xf.abs().amax()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    return ((xf * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


def precise_matmuls() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
