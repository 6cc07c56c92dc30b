"""The routed experts of a mixture-of-experts layer: a grouped GEMM over
token-expert pairs sorted on the device, in CUDA (``csrc/moe_gemm.cu``).

Replaces no TPU kernel: the JAX package has no mixture of experts. It was
added for the MLA/MoE language model (``models/mla_moe.py``), whose experts
do most of its work: a per-expert loop in PyTorch needs data-dependent
shapes (a host sync each layer, and no CUDA graph) and three GEMMs an
expert.

``routed_experts(x, idx, weight, gate, up, down)`` takes tokens ``x``
(T, hidden), each token's experts ``idx`` (T, k) and float32 weights, and
the stacked expert projections ``gate``, ``up`` (E, width, hidden) and
``down`` (E, hidden, width). Every pair's output is
``down_e(silu(gate_e(x)) * up_e(x))`` with each product rounded to the
compute type where ``F.linear`` rounds it (gate, its silu, up, their
product, down); the pairs' outputs are weighted and summed per token in
float32 and cast back. For a CUDA tensor it launches, with no host sync and
a grid fixed by T, k and E (so that a CUDA graph replays it):

1. ``_align``: the pairs sorted by expert (a stable sort), each expert's
   run padded to a multiple of the row block, and each row block's expert
   (``E`` past the last run): plain PyTorch on the device;
2. ``bbocr_moe_gate_up_kernel_<type>_<tiling>``: a row block of pairs
   against one expert's gate and up rows, both products summed in float32
   in one pass over the hidden size, silu(gate) * up stored;
3. ``bbocr_moe_down_kernel_<type>_<tiling>``: those rows against the
   expert's down projection, each pair's output stored in its own row
   (pair order), so that the weighted sum over a token's pairs is one
   deterministic reduction.

Bound: in decode (a few pairs an expert) by the experts' weights, read once
a row block (3 * E * width * hidden values a layer); in prefill (thousands
of pairs an expert) by the tensor cores. The tiling follows from the pairs
an expert gets (``_decode_tiling``): 32-row blocks where they are few, so
that decode reads each expert's weights about once, 128-row ones where
they are many. For a CPU tensor it returns ``routed_experts_plain``, a loop
over the experts, which it counts apart.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from bbocr_tpu_torch.kernels import build


def combine(y: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(T * k, hidden) pair outputs -> (T, hidden): weighted and summed per
    token in float32, cast back (as the published ``moe_infer`` does)."""
    t, k = weight.shape
    return (y.view(t, k, -1).float() * weight[..., None]).sum(dim=1).to(y.dtype)


def routed_experts_plain(x, idx, weight, gate, up, down) -> torch.Tensor:
    """The same function as a loop over the experts (host syncs: it finds
    each expert's pairs)."""
    routed_experts_plain.launches += 1
    k = idx.shape[1]
    flat = idx.reshape(-1)
    y = x.new_zeros(flat.numel(), x.shape[1])
    for e in range(gate.shape[0]):
        pairs = (flat == e).nonzero()[:, 0]
        if pairs.numel():
            xe = x[pairs // k]
            y[pairs] = F.linear(F.silu(F.linear(xe, gate[e])) * F.linear(xe, up[e]), down[e])
    return combine(y, weight)


routed_experts_plain.launches = 0


def _decode_tiling(pairs: int, experts: int) -> bool:
    """The decode tiling (32-row blocks: the experts' weights are the
    traffic) where an expert gets few pairs, the prefill one (128-row
    blocks: the tensor cores are) where it gets many."""
    return pairs < 32 * experts


def _align(idx: torch.Tensor, experts: int, bm: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pair of each padded row (rows,), ``P`` where a row is padding; expert
    of each row block (rows / bm,), ``experts`` past the last run), with
    rows = P + experts * (bm - 1) rounded up to bm: shapes fixed by P."""
    flat = idx.reshape(-1)
    p = flat.numel()
    counts = torch.zeros(experts, dtype=torch.int64, device=idx.device).index_add_(0, flat, torch.ones_like(flat))
    padded = (counts + bm - 1) // bm * bm
    ends = torch.cumsum(padded, 0)
    order = torch.sort(flat, stable=True).indices
    sorted_e = flat[order]
    rank = torch.arange(p, device=idx.device) - (torch.cumsum(counts, 0) - counts)[sorted_e]
    rows = (p + experts * (bm - 1) + bm - 1) // bm * bm
    pair_of_row = torch.full((rows,), p, dtype=torch.int64, device=idx.device)
    pair_of_row[(ends - padded)[sorted_e] + rank] = order
    starts = torch.arange(0, rows, bm, device=idx.device)
    return pair_of_row, torch.searchsorted(ends, starts, right=True)


_DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # the kernels' types: bfloat16 as published, float32 for tests


@functools.lru_cache(maxsize=None)
def _block_rows(decode: bool) -> int:
    return int(build.load_moe().bbocr_moe_block_rows(int(decode)))


def _check(x, idx, weight, gate, up, down) -> None:
    e, width, hidden = gate.shape
    if x.ndim != 2 or x.shape[1] != hidden or up.shape != gate.shape or down.shape != (e, hidden, width):
        raise ValueError(f"shapes do not fit: x {tuple(x.shape)}, gate/up {tuple(gate.shape)} {tuple(up.shape)}, "
                         f"down {tuple(down.shape)}")
    if idx.shape != weight.shape or idx.shape[0] != x.shape[0] or weight.dtype != torch.float32:
        raise ValueError(f"idx {tuple(idx.shape)} and float32 weight {tuple(weight.shape)} {weight.dtype} "
                         f"must be (tokens, k)")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (gate, up, down)):
        raise ValueError("x and the expert projections must share one type, bfloat16 or float32")
    if any(not t.is_contiguous() for t in (x, gate, up, down)):
        raise ValueError("expected contiguous tensors")
    if len({t.device for t in (x, idx, weight, gate, up, down)}) != 1:
        raise ValueError("all tensors must lie on one device")


def _check_cuda(x, gate, up, down) -> None:
    """What the kernels' 16-byte copies need: rows of whole 16-byte pieces
    from 16-byte-aligned starts."""
    vec = 16 // x.element_size()
    if gate.shape[1] % vec or gate.shape[2] % vec:
        raise ValueError(f"hidden and width must be multiples of {vec} for {x.dtype}, got {tuple(gate.shape[1:])}")
    if any(t.data_ptr() % 16 for t in (x, gate, up, down)):
        raise ValueError("x and the expert projections must start on 16-byte boundaries")


def routed_experts(x, idx, weight, gate, up, down) -> torch.Tensor:
    """(T, hidden) routed experts' output; see the module's docstring."""
    _check(x, idx, weight, gate, up, down)
    if x.device.type == "cpu":
        return routed_experts_plain(x, idx, weight, gate, up, down)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda(x, gate, up, down)
    lib = build.load_moe()
    e, width, hidden = gate.shape
    t, k = idx.shape
    p = t * k
    decode = _decode_tiling(p, e)
    pair_of_row, tile_e = _align(idx, e, _block_rows(decode))
    h = torch.empty(pair_of_row.numel(), width, dtype=x.dtype, device=x.device)
    y = torch.empty(p, hidden, dtype=x.dtype, device=x.device)
    dtype, blocks = _DTYPES[x.dtype], tile_e.numel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bbocr_moe_gate_up(dtype, int(decode), x.data_ptr(), gate.data_ptr(), up.data_ptr(), h.data_ptr(),
                                    pair_of_row.data_ptr(), tile_e.data_ptr(), blocks, p, k, width, hidden, e, stream)
        if err == 0:
            err = lib.bbocr_moe_down(dtype, int(decode), h.data_ptr(), down.data_ptr(), y.data_ptr(),
                                     pair_of_row.data_ptr(), tile_e.data_ptr(), blocks, p, hidden, width, e, stream)
    if err != 0:
        raise RuntimeError(f"routed_experts launch failed: CUDA error {err}")
    routed_experts.launches += 1
    return combine(y, weight)


routed_experts.launches = 0


def reset_launches() -> None:
    routed_experts.launches = 0
    routed_experts_plain.launches = 0
