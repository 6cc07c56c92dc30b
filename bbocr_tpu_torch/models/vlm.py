"""PageReader: an end-to-end page -> JSON vision model, torch modules.

Counterpart of ``bbocr_tpu/models/vlm.py``: a patch-embedding encoder (an
8x8/8 patch conv on a gray page, fixed 2-D sin/cos positions, pre-norm
transformer blocks) and a causal decoder with cross-attention that emits
the metadata JSON character by character. ``greedy_generate`` gives the
tokens of the JAX ``lax.scan``, which sends the whole static token buffer
through the decoder at every step with no early stop; here each step
decodes one position against a static cache of the earlier ones
(``DecodeState``), replayed as a CUDA graph on a card.

The parameters stay float32, as flax keeps them, and every layer computes
in the module's ``dtype`` the way flax 0.12 computes with ``dtype`` set:

- ``Dense`` and ``DenseGeneral`` cast the input and the kernel to
  ``dtype``, round the product to ``dtype`` and then add the bias cast to
  ``dtype`` (products of the rounded values are summed in float32);
- ``LayerNorm`` (epsilon 1e-6) takes mean and mean of squares in float32,
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, and
  rounds once to ``dtype``;
- attention (``flax.linen.attention.dot_product_attention``) divides the
  query by ``sqrt(head_dim)`` in ``dtype``, rounds the scores to
  ``dtype``, masks with ``finfo(dtype).min`` and runs the softmax in
  ``dtype`` (its sum accumulated in float32, as ``jnp.sum`` does);
- ``nn.gelu`` is the tanh form, ``x * (0.5 * (1 + tanh(c * (x + 0.044715
  x^3))))``, each operation rounded to ``dtype`` with its constants in
  ``dtype``;
- ``nn.Embed`` casts the table to ``dtype`` and gathers; the head is a
  float32 ``Dense`` over the rounded ``out_norm`` output.

Constants that divide or multiply a tensor are tensors on its device:
CUDA turns a division by a host scalar into a product with its reciprocal.
Attention is written in plain ops in flax's order, not with
``F.scaled_dot_product_attention``, which sums and rounds otherwise, and
the patch conv is a reshape and one product (64 taps), not cuDNN, whose
TF32 default would make float32 inexact.
"""

from __future__ import annotations

import functools
import math
import weakref
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils._pytree import tree_leaves, tree_map

from bbocr_tpu_torch.models import graphed
from bbocr_tpu_torch.models.charset import EN_CHARSET
from bbocr_tpu_torch.utils import profiling
from bbocr_tpu_torch.utils.profiling import span

# Token vocabulary: JSON is emitted as characters; specials sit above the
# charset ids (0 = CTC blank / PAD here too, so charset ids align).
PAD_ID = 0
_CHARS = EN_CHARSET.chars  # ids 1..len(chars)
BOS_ID = len(_CHARS) + 1
EOS_ID = len(_CHARS) + 2
VOCAB_SIZE = len(_CHARS) + 3

MAX_JSON_LEN = 192  # decoded JSON length budget (tokens incl. BOS/EOS)

LAYERNORM_EPS = 1e-6  # flax.linen.LayerNorm's default


def encode_json(text: str, max_len: int = MAX_JSON_LEN) -> Tuple[np.ndarray, int]:
    """JSON string -> (max_len,) int32 token ids: BOS body EOS PAD..."""
    ids = [BOS_ID]
    for ch in text:
        idx = _CHARS.find(ch)
        if idx >= 0:
            ids.append(idx + 1)
    ids = ids[: max_len - 1]
    ids.append(EOS_ID)
    out = np.zeros(max_len, np.int32)
    out[: len(ids)] = ids
    return out, len(ids)


def decode_ids(ids) -> str:
    """Token ids -> JSON string (stops at EOS, skips PAD/BOS)."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    out = []
    for i in np.asarray(ids).tolist():
        if i == EOS_ID:
            break
        if i in (PAD_ID, BOS_ID):
            continue
        if 1 <= i <= len(_CHARS):
            out.append(_CHARS[i - 1])
    return "".join(out)


def _sincos_2d(h: int, w: int, dim: int) -> np.ndarray:
    """Fixed 2-D sin/cos position embedding, (h*w, dim)."""
    assert dim % 4 == 0
    d4 = dim // 4
    omega = 1.0 / (10000 ** (np.arange(d4) / d4))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = np.concatenate(
        [
            np.sin(ys.reshape(-1, 1) * omega),
            np.cos(ys.reshape(-1, 1) * omega),
            np.sin(xs.reshape(-1, 1) * omega),
            np.cos(xs.reshape(-1, 1) * omega),
        ],
        axis=1,
    )
    return out.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _const(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``value`` rounded to float32 and then to ``dtype``, as a 0-d tensor on
    ``device`` (numpy constants and weakly typed Python floats in JAX take
    the array's type before the operation). Made once per device: a copy
    from the host would wait for the device's queue."""
    return torch.tensor(float(np.float32(value)), dtype=torch.float32, device=device).to(dtype)


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense`` with ``dtype``: the product of the input and the kernel,
    both cast to ``dtype``, summed in float32 and rounded to ``dtype``, plus
    the bias cast to ``dtype``."""
    return _dense(x, *_cast_linear(layer, dtype), dtype)


def _cast_linear(layer: nn.Linear, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """A layer's kernel and bias as ``dense`` reads them: the kernel rounded
    to ``dtype`` and held in float32, the bias in ``dtype``."""
    return layer.weight.to(dtype).float(), layer.bias.to(dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    y = torch.matmul(x.to(dtype).float(), w.t()).to(dtype)
    return y + b


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``flax.linen.gelu`` (``approximate=True``) in ``x``'s type, each
    operation rounded as JAX rounds it op by op."""
    dt, dev = x.dtype, x.device
    inner = x + _const(0.044715, dt, dev) * (x * x * x)
    cdf = _const(0.5, dt, dev) * (_const(1.0, dt, dev) + torch.tanh(_const(math.sqrt(2 / math.pi), dt, dev) * inner))
    return x * cdf


class LayerNorm(nn.Module):
    """flax ``LayerNorm(dtype=...)``: float32 statistics (``E[x^2] -
    E[x]^2``, clipped at 0), float32 affine, one rounding to ``dtype``."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _layer_norm(x, self.weight, self.bias, dtype)


def _layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    mean2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + LAYERNORM_EPS) * weight
    return ((xf - mean) * mul + bias).to(dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """flax ``dot_product_attention`` after the query's scaling: ``q`` (b, h,
    t, hd) in ``dtype``; ``k`` (b, h, hd, s) and ``v`` (b, h, s, hd) in
    float32, holding values rounded to ``dtype``; ``mask`` broadcasts to (b,
    h, t, s). Returns (b, h, t, hd) in ``dtype``."""
    # 'bqhd,bkhd->bhqk', rounded to dtype
    w = torch.matmul(q.float(), k).to(dtype)
    if mask is not None:
        w = torch.where(mask, w, _const(torch.finfo(dtype).min, dtype, w.device))
    e = torch.exp(w - w.amax(dim=-1, keepdim=True))
    p = e / e.float().sum(dim=-1, keepdim=True).to(dtype)
    # 'bhqk,bkhd->bqhd', rounded to dtype
    return torch.matmul(p.float(), v).to(dtype)


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention``: ``DenseGeneral`` projections to
    (heads, head_dim) with biases, ``dot_product_attention``, and the
    ``out`` projection over (heads, head_dim). The weights are the flax
    kernels flattened to ``Linear`` layout (``convert.pagereader_state_dict``)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, xq: torch.Tensor, xkv: torch.Tensor, mask: Optional[torch.Tensor], dtype) -> torch.Tensor:
        b, t, d = xq.shape
        s = xkv.shape[1]
        hd = d // self.heads
        q = dense(xq, self.query, dtype).reshape(b, t, self.heads, hd)
        k = dense(xkv, self.key, dtype).reshape(b, s, self.heads, hd)
        v = dense(xkv, self.value, dtype).reshape(b, s, self.heads, hd)
        q = q / _const(math.sqrt(hd), dtype, q.device)
        o = _attend(q.permute(0, 2, 1, 3), k.float().permute(0, 2, 3, 1), v.float().permute(0, 2, 1, 3), mask, dtype)
        return dense(o.permute(0, 2, 1, 3).reshape(b, t, d), self.out, dtype)


class Block(nn.Module):
    """Pre-norm block: self-attention, optional cross-attention to ``ctx``,
    then a GELU MLP of width 4 * dim. ``norms`` and ``attns`` are flax's
    ``LayerNorm_i`` and ``MultiHeadDotProductAttention_i`` in call order."""

    def __init__(self, dim: int, heads: int, cross: bool = False):
        super().__init__()
        self.cross = cross
        self.norms = nn.ModuleList([LayerNorm(dim) for _ in range(3 if cross else 2)])
        self.attns = nn.ModuleList([Attention(dim, heads) for _ in range(2 if cross else 1)])
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x, dtype, ctx=None, mask=None):
        h = self.norms[0](x, dtype)
        x = x + self.attns[0](h, h, mask, dtype)
        if self.cross:
            h = self.norms[1](x, dtype)
            x = x + self.attns[1](h, ctx, None, dtype)
        h = self.norms[-1](x, dtype)
        h = dense(gelu_tanh(dense(h, self.fc1, dtype)), self.fc2, dtype)
        return x + h


class PageEncoder(nn.Module):
    """(B, H, W, 1) gray page in [0, 255] -> (B, H/8 * W/8, dim) tokens."""

    def __init__(self, dim: int = 192, depth: int = 6, heads: int = 6, patch: int = 8):
        super().__init__()
        self.patch = patch
        self.conv = nn.Linear(patch * patch, dim)  # the HWIO kernel as (dim, kh * kw)
        self.blocks = nn.ModuleList([Block(dim, heads) for _ in range(depth)])
        self.norm = LayerNorm(dim)

    def forward(self, page: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = page.float() / _const(127.5, torch.float32, page.device) - _const(1.0, torch.float32, page.device)
        b, hh, ww, _ = x.shape
        p = self.patch
        if hh % p or ww % p:
            raise ValueError(f"page {hh}x{ww} is not a multiple of the {p}-px patch ('SAME' would pad it)")
        h, w = hh // p, ww // p
        # stride-p patches, taps in (kh, kw) order: one product per patch
        patches = x[..., 0].reshape(b, h, p, w, p).permute(0, 1, 3, 2, 4).reshape(b, h * w, p * p)
        x = dense(patches, self.conv, dtype)
        pos = torch.from_numpy(_sincos_2d(h, w, x.shape[-1])).to(x.device).to(dtype)
        x = x + pos[None]
        for blk in self.blocks:
            x = blk(x, dtype)
        return self.norm(x, dtype)


class PageReader(nn.Module):
    """Donut-style encoder-decoder computing in ``dtype`` over float32
    parameters. ``ctc_head`` is the auxiliary CTC head over the encoder's
    tokens that training adds; ``load_params`` drops it for checkpoints
    that have none (inference never applies it)."""

    def __init__(
        self,
        dim: int = 192,
        enc_depth: int = 6,
        dec_depth: int = 4,
        heads: int = 6,
        patch: int = 8,
        vocab: int = VOCAB_SIZE,
        max_len: int = MAX_JSON_LEN,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.dim, self.vocab, self.max_len, self.dtype = dim, vocab, max_len, dtype
        self.encoder = PageEncoder(dim, enc_depth, heads, patch)
        self.tok_embed = nn.Embedding(vocab, dim)
        self.pos_embed = nn.Embedding(max_len, dim)
        self.blocks = nn.ModuleList([Block(dim, heads, cross=True) for _ in range(dec_depth)])
        self.out_norm = LayerNorm(dim)
        self.head = nn.Linear(dim, vocab)
        self.ctc_head: Optional[nn.Linear] = nn.Linear(dim, len(_CHARS) + 1)

    def load_params(self, tree: Any) -> "PageReader":
        """Load a flax parameter tree (``{"params": ...}``, as
        ``utils.checkpoint.load_params`` reads an ``.npz``), with or without
        ``ctc_head``, every other key used on both sides."""
        from bbocr_tpu_torch.models.convert import pagereader_state_dict

        sd = pagereader_state_dict(tree)
        has_ctc = any(k.startswith("ctc_head.") for k in sd)
        if not has_ctc:
            self.ctc_head = None
        elif self.ctc_head is None:
            self.ctc_head = nn.Linear(self.dim, len(_CHARS) + 1).to(self.head.weight.device)
        self.load_state_dict(sd, strict=True)
        return self

    def encode(self, page: torch.Tensor) -> torch.Tensor:
        return self.encoder(page, self.dtype)

    def encode_ctc(self, page: torch.Tensor):
        """(ctx, ctc_logits): encoder tokens + per-token character logits."""
        if self.ctc_head is None:
            raise ValueError("this PageReader's parameters have no ctc_head")
        ctx = self.encode(page)
        return ctx, dense(ctx.float(), self.ctc_head, torch.float32)

    def decode(self, ctx: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """ctx (B, S, d); tokens (B, T) -> float32 logits (B, T, vocab)."""
        t = tokens.shape[1]
        dt = self.dtype
        pos = torch.arange(t, device=tokens.device)
        x = self.tok_embed.weight.to(dt)[tokens] + self.pos_embed.weight.to(dt)[pos][None]
        mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=tokens.device))[None, None]
        for blk in self.blocks:
            x = blk(x, dt, ctx=ctx, mask=mask)
        return dense(self.out_norm(x, dt).float(), self.head, torch.float32)

    def forward(self, page: torch.Tensor, tokens: torch.Tensor, with_ctc: bool = False):
        if with_ctc:
            ctx, ctc_logits = self.encode_ctc(page)
            return self.decode(ctx, tokens), ctc_logits
        return self.decode(self.encode(page), tokens)


class DecodeState(graphed.StepState):
    """Greedy decoding one position a step, over static buffers for one
    (model, batch, page tokens, ``max_len``, device).

    ``load`` fills the buffers for a call: each decoder parameter cast as
    its layer reads it, the cross-attention keys and values of ``ctx`` in
    every block, zeroed self-attention caches of ``max_len`` slots a
    block, BOS in slot 0 and PAD elsewhere, and the step index 0 (a device
    tensor). ``step`` then decodes position ``t``: it embeds token ``t`` at
    position ``t``, writes that position's self-attention key and value
    into slot ``t`` of its block's cache, attends over all ``max_len``
    slots with the mask ``slot <= t`` (the same ``where``, max, exp and
    float32 sum over every slot as ``Attention.forward``), puts the float32
    logits of the position in ``logits``, writes their argmax (the first
    index wins ties) into slot ``t + 1`` of ``tokens``, or EOS where the
    row already holds one, and moves the index on. Every value a step
    computes is the one that row ``t`` of ``PageReader.decode`` computes
    from the same tokens, rounded where that rounds; only the products'
    float32 sums may run in another order, as the GEMMs differ in shape.

    ``capture`` (``graphed.StepState``) records one ``step`` as a CUDA
    graph (``graph``), each replay of which is a step: it reads and writes
    only these buffers, with no host sync. ``lock`` guards the buffers
    through a call.
    """

    def __init__(self, model: PageReader, batch: int, ctx_len: int, max_len: int, device: torch.device):
        super().__init__(device)
        dt = model.dtype
        d, heads = model.dim, model.blocks[0].attns[0].heads
        self.dtype, self.heads = dt, heads
        self.weights = tree_map(torch.clone, _cast_decoder(model))
        # keys and values rounded to dt, held in float32 as the products read them
        self.cross = [torch.empty(2, batch, heads, ctx_len, d // heads, device=device) for _ in model.blocks]
        self.cache = [torch.empty(2, batch, heads, max_len, d // heads, device=device) for _ in model.blocks]
        self.tokens = torch.empty(batch, max_len, dtype=torch.int64, device=device)
        self.logits = torch.empty(batch, model.vocab, device=device)
        self.t = torch.zeros((), dtype=torch.int64, device=device)
        self.slots = torch.arange(max_len, device=device)
        self.eos = torch.full((), EOS_ID, dtype=torch.int64, device=device)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """(b, t, d) -> (b, heads, t, d / heads)."""
        b, t, d = x.shape
        return x.reshape(b, t, self.heads, d // self.heads).permute(0, 2, 1, 3)

    def load(self, model: PageReader, ctx: torch.Tensor) -> None:
        dt = self.dtype
        torch._foreach_copy_(tree_leaves(self.weights), tree_leaves(_cast_decoder(model)))
        for blk, cross in zip(self.weights["blocks"], self.cross):
            _, key, value, _ = blk["attns"][1]
            cross[0].copy_(self._heads(_dense(ctx, *key, dt)))
            cross[1].copy_(self._heads(_dense(ctx, *value, dt)))
        for cache in self.cache:
            cache.zero_()
        self.tokens.fill_(PAD_ID)
        self.tokens[:, 0] = BOS_ID
        self.t.zero_()

    def step(self) -> None:
        dt, w = self.dtype, self.weights
        b = self.tokens.shape[0]
        at = self.t.view(1)
        x = w["tok"][self.tokens.index_select(1, at)] + w["pos"].index_select(0, at)[None]
        causal = self.slots <= self.t
        scale = _const(math.sqrt(x.shape[-1] // self.heads), dt, x.device)
        for blk, cache, (ck, cv) in zip(w["blocks"], self.cache, self.cross):
            (query, key, value, out), (cquery, _, _, cout) = blk["attns"]
            h = _layer_norm(x, *blk["norms"][0], dt)
            cache[0].index_copy_(2, at, self._heads(_dense(h, *key, dt)).float())
            cache[1].index_copy_(2, at, self._heads(_dense(h, *value, dt)).float())
            o = _attend(self._heads(_dense(h, *query, dt)) / scale, cache[0].transpose(2, 3), cache[1], causal, dt)
            x = x + _dense(o.permute(0, 2, 1, 3).reshape(b, 1, -1), *out, dt)
            h = _layer_norm(x, *blk["norms"][1], dt)
            o = _attend(self._heads(_dense(h, *cquery, dt)) / scale, ck.transpose(2, 3), cv, None, dt)
            x = x + _dense(o.permute(0, 2, 1, 3).reshape(b, 1, -1), *cout, dt)
            h = _layer_norm(x, *blk["norms"][2], dt)
            x = x + _dense(gelu_tanh(_dense(h, *blk["fc1"], dt)), *blk["fc2"], dt)
        self.logits.copy_(_dense(_layer_norm(x, *w["out_norm"], dt).float(), *w["head"], torch.float32)[:, 0])
        nxt = torch.argmax(self.logits, dim=-1)
        # after EOS, keep emitting EOS (stable decode)
        done = torch.any(self.tokens == EOS_ID, dim=1)
        self.tokens.index_copy_(1, at + 1, torch.where(done, self.eos, nxt)[:, None])
        self.t += 1


def _cast_decoder(model: PageReader) -> Dict[str, Any]:
    """The decoder's parameters as its layers read them, cast once: the
    embeddings in the compute type, each ``dense`` layer's kernel and bias
    (``_cast_linear``; the head's in float32), the LayerNorms' as they are."""
    dt = model.dtype
    return {
        "tok": model.tok_embed.weight.to(dt),
        "pos": model.pos_embed.weight.to(dt),
        "blocks": [
            {
                "norms": [(n.weight, n.bias) for n in blk.norms],
                "attns": [[_cast_linear(lin, dt) for lin in (a.query, a.key, a.value, a.out)] for a in blk.attns],
                "fc1": _cast_linear(blk.fc1, dt),
                "fc2": _cast_linear(blk.fc2, dt),
            }
            for blk in model.blocks
        ],
        "out_norm": (model.out_norm.weight, model.out_norm.bias),
        "head": _cast_linear(model.head, torch.float32),
    }


# model -> {(batch, page tokens, max_len, dtype, device): DecodeState}
# (``graphed.state_for``)
_STATES: "weakref.WeakKeyDictionary[PageReader, Dict[tuple, DecodeState]]" = weakref.WeakKeyDictionary()


def _graphed_state(model: PageReader, ctx: torch.Tensor, max_len: int) -> DecodeState:
    key = (ctx.shape[0], ctx.shape[1], max_len, model.dtype, ctx.device)
    return graphed.state_for(
        _STATES, model, key, lambda: DecodeState(model, ctx.shape[0], ctx.shape[1], max_len, ctx.device))


@torch.no_grad()
def greedy_generate(model: PageReader, page: torch.Tensor, max_len: int = MAX_JSON_LEN) -> torch.Tensor:
    """Greedy page -> (B, max_len) token ids, those of the JAX ``lax.scan``:
    BOS in slot 0 and PAD elsewhere; at each of the ``max_len - 1`` steps
    ``argmax`` of position ``t``'s logits (the first index wins ties) fills
    slot ``t + 1``, and a row that holds EOS keeps emitting EOS. Each step
    is one ``DecodeState.step``; on a CUDA device, one replay of its graph,
    captured at the first call for the model, batch, page size, ``max_len``,
    type and device, with the parameters and the page loaded afresh at every
    call. No host sync inside the loop. Spans (when recording,
    ``utils/profiling.py``): ``vlm.generate`` for the call, a batch of its
    own, with ``vlm.encode`` and one ``vlm.step`` a step (``graph``: the step
    replayed a graph)."""
    with profiling.batch(), span("vlm.generate", pages=page.shape[0]):
        with span("vlm.encode"):
            ctx = model.encode(page)
        is_cuda = page.device.type == "cuda"
        if is_cuda:
            state = _graphed_state(model, ctx, max_len)
        else:
            state = DecodeState(model, ctx.shape[0], ctx.shape[1], max_len, ctx.device)
        with state.lock:
            graphed.run_steps(state, max_len - 1, lambda: state.load(model, ctx), is_cuda, "vlm.step")
            return state.tokens.clone()
