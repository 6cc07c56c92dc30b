"""The collectives GSPMD inserts around a sharded program, written out.

- ``gather``: a product computed with this rank's slice of a weight gives
  this rank's slice of the output channels; the tp group all-gathers them
  along the channel axis, so everything downstream sees the whole tensor
  again. Its gradient is the slice of the incoming gradient that belongs
  to this rank (the downstream work is replicated over the tp group, so
  every rank holds the same incoming gradient).
- ``into_tp``: the identity on the way in to such a product; its gradient
  is summed over the tp group, since each rank's slice of the product
  contributes only its part of the input's gradient.
- ``all_gather_cat``: a group's tensors concatenated along an axis (the
  dp group's row blocks of the engine's outputs).

``TPSlice`` marks a layer whose weight is this rank's contiguous slice of
its output channels; the layers of ``models/`` read it from their ``tp``
attribute (None when unsharded).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class TPSlice:
    group: Any  # the tp process group
    rank: int  # this rank's tp coordinate
    size: int  # tp


def all_gather_cat(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, in rank order, concatenated along ``dim``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp, ctx.width = dim, tp, x.shape[dim]
        return all_gather_cat(x, dim, tp.group, tp.size)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.tp.rank * ctx.width, ctx.width), None, None


class _IntoTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.tp.group)
        return grad, None


def gather(x: torch.Tensor, dim: int, tp: TPSlice) -> torch.Tensor:
    """This rank's slice of output channels -> the whole tensor (all-gather
    over the tp group along ``dim``)."""
    return _Gather.apply(x, dim % x.ndim, tp)


def into_tp(x: torch.Tensor, tp: TPSlice) -> torch.Tensor:
    """The input of a sharded product: the identity, its gradient summed
    over the tp group."""
    return _IntoTP.apply(x, tp) if x.requires_grad else x
