"""Plain reference of ``pagereader_5m`` and the judge of its served tokens.

A Donut-style page reader (Kim et al., https://arxiv.org/abs/2111.15664)
as the configuration file sizes it: an 8x8 patch embedding of a gray page,
fixed 2-D sin/cos positions, pre-norm transformer encoder blocks, and a
causal decoder with cross-attention over the encoder's tokens that emits
the metadata JSON one character at a time; LayerNorm with eps 1e-6, a tanh
GELU MLP of four times the width. Plain PyTorch and NumPy in float32 on
the ``.npz`` weights read with NumPy; it imports nothing of the program.

It makes the page again from the decoded gray plane (Pillow's BILINEAR
resize, keeping the aspect, at the top left of a white page) and runs the
decoder once, teacher-forced, over the served tokens. ``token_gap``: the
widest gap by which a served token's logit lies below the reference's
best logit at its position, up to the first EOS. The control reads, at
the same positions, the gap of the token that the float8 reference puts
first.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

Q = Callable[[torch.Tensor], torch.Tensor]
LN_EPS = 1e-6


def load_params(path: str, device) -> Dict[str, torch.Tensor]:
    with np.load(path) as z:
        return {k.split("/", 1)[1]: torch.from_numpy(np.asarray(z[k], np.float32)).to(device) for k in z.files}


# ----------------------------------------------------------------------
# The page
# ----------------------------------------------------------------------


def _bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of Pillow's BILINEAR: a triangle filter widened
    by the downscale factor, sample centres at (i + 0.5) * scale."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    w = np.zeros((n_out, n_in))
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(math.floor(center - support)), 0)
        hi = min(int(math.ceil(center + support)), n_in)
        x = (np.arange(lo, hi) + 0.5 - center) / support
        tri = np.clip(1.0 - np.abs(x), 0.0, None)
        w[i, lo:hi] = tri / tri.sum()
    return w


def resize_bilinear_u8(gray: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Horizontal pass, then vertical, each rounded to uint8 (as Pillow does)."""
    g = gray.astype(np.float64)
    if out_w != g.shape[1]:
        g = np.clip(np.round(g @ _bilinear_weights(g.shape[1], out_w).T), 0, 255)
    if out_h != g.shape[0]:
        g = np.clip(np.round(_bilinear_weights(g.shape[0], out_h) @ g), 0, 255)
    return g.astype(np.uint8)


def make_page(gray: np.ndarray, page_h: int, page_w: int) -> np.ndarray:
    h, w = gray.shape
    scale = min(page_h / h, page_w / w)
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    page = np.full((page_h, page_w), 255.0, np.float32)
    page[:nh, :nw] = resize_bilinear_u8(gray, nh, nw)
    return page


# ----------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------


def sincos_2d(h: int, w: int, dim: int) -> torch.Tensor:
    d4 = dim // 4
    omega = 1.0 / (10000 ** (np.arange(d4) / d4))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ys, xs = ys.reshape(-1, 1) * omega, xs.reshape(-1, 1) * omega
    return torch.from_numpy(np.concatenate([np.sin(ys), np.cos(ys), np.sin(xs), np.cos(xs)], 1).astype(np.float32))


def _ln(x, p, name):
    return torch.nn.functional.layer_norm(x, x.shape[-1:], p[name + "/scale"], p[name + "/bias"], LN_EPS)


def _dense(x, p, name, q: Q):
    w = p[name + "/kernel"]
    return torch.matmul(q(x), q(w.reshape(w.shape[0], -1))) + p[name + "/bias"].reshape(-1)


def _attention(xq, xkv, p, name, heads: int, q: Q, causal: bool):
    b, t, d = xq.shape
    s = xkv.shape[1]
    hd = d // heads
    qh = _dense(xq, p, name + "/query", q).reshape(b, t, heads, hd).transpose(1, 2)
    kh = _dense(xkv, p, name + "/key", q).reshape(b, s, heads, hd).transpose(1, 2)
    vh = _dense(xkv, p, name + "/value", q).reshape(b, s, heads, hd).transpose(1, 2)
    scores = torch.matmul(q(qh), q(kh.transpose(-1, -2))) / math.sqrt(hd)
    if causal:
        keep = torch.ones(t, s, dtype=torch.bool, device=xq.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    o = torch.matmul(q(torch.softmax(scores, -1)), q(vh)).transpose(1, 2).reshape(b, t, d)
    w = p[name + "/out/kernel"]
    return torch.matmul(q(o), q(w.reshape(-1, w.shape[-1]))) + p[name + "/out/bias"]


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def _block(x, p, name, heads, q, ctx=None):
    causal = ctx is not None  # decoder blocks are causal and cross-attend
    h = _ln(x, p, name + "/LayerNorm_0")
    x = x + _attention(h, h, p, name + "/MultiHeadDotProductAttention_0", heads, q, causal)
    last = 1
    if ctx is not None:
        h = _ln(x, p, name + "/LayerNorm_1")
        x = x + _attention(h, ctx, p, name + "/MultiHeadDotProductAttention_1", heads, q, False)
        last = 2
    h = _ln(x, p, name + f"/LayerNorm_{last}")
    return x + _dense(_gelu(_dense(h, p, name + "/Dense_0", q)), p, name + "/Dense_1", q)


def encode(p, pages: torch.Tensor, cfg: Dict, q: Q) -> torch.Tensor:
    """(B, H, W) pages in [0, 255] -> (B, H/8 * W/8, dim)."""
    pt = cfg["patch"]
    x = pages.float() / 127.5 - 1.0
    b, hh, ww = x.shape
    h, w = hh // pt, ww // pt
    patches = x.reshape(b, h, pt, w, pt).permute(0, 1, 3, 2, 4).reshape(b, h * w, pt * pt)
    k = p["encoder/Conv_0/kernel"].reshape(pt * pt, -1)
    x = torch.matmul(q(patches), q(k)) + p["encoder/Conv_0/bias"]
    x = x + sincos_2d(h, w, x.shape[-1]).to(x.device)
    for i in range(cfg["enc_depth"]):
        x = _block(x, p, f"encoder/Block_{i}", cfg["heads"], q)
    return _ln(x, p, "encoder/LayerNorm_0")


def decode(p, ctx: torch.Tensor, tokens: torch.Tensor, cfg: Dict, q: Q) -> torch.Tensor:
    """Teacher-forced logits (B, T, vocab) of the causal decoder."""
    t = tokens.shape[1]
    x = p["tok_embed/embedding"][tokens] + p["pos_embed/embedding"][:t][None]
    for i in range(cfg["dec_depth"]):
        x = _block(x, p, f"blocks_{i}", cfg["heads"], q, ctx=ctx)
    x = _ln(x, p, "out_norm")
    return torch.matmul(q(x), q(p["head/kernel"])) + p["head/bias"]


def served_length(row: np.ndarray, eos: int) -> int:
    """Slots up to and including the first EOS (the whole row without one)."""
    hits = np.nonzero(row == eos)[0]
    return int(hits[0]) + 1 if len(hits) else len(row)


class PageReference:
    def __init__(self, config: Dict, root: str, device):
        self.cfg = config
        self.device = device
        self.p = load_params(f"{root}/{config['checkpoint']}", device)

    @torch.no_grad()
    def gaps(self, grays: List[np.ndarray], tokens: np.ndarray, q_first: Q = None) -> Tuple[float, int]:
        """(widest gap, positions judged) over pages and their served token
        rows (B, max_len), BOS first. With ``q_first`` the gap is that of
        the token the model computed with ``q_first`` puts first, at the same
        positions."""
        from portbench.core.lowp import exact

        cfg = self.cfg
        eos = cfg["eos_id"]
        worst, judged = 0.0, 0
        for gray, row in zip(grays, tokens):
            page = torch.from_numpy(make_page(gray, cfg["page_h"], cfg["page_w"]))[None].to(self.device)
            n = served_length(row, eos)
            toks = torch.from_numpy(row[:n].astype(np.int64))[None].to(self.device)
            logits = decode(self.p, encode(self.p, page, cfg, exact), toks[:, :-1], cfg, exact)[0]
            if q_first is None:
                served = toks[0, 1:]
            else:
                low = decode(self.p, encode(self.p, page, cfg, q_first), toks[:, :-1], cfg, q_first)[0]
                served = low.argmax(-1)
            gap = logits.max(-1).values - logits.gather(1, served[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
            judged += n - 1
        return worst, judged


def page_flops(cfg: Dict, served: int) -> int:
    """FLOPs a page needs: the encoder once, then a causal decode with a
    cache over ``served`` positions (the cross-attention's keys and values
    made once), and the head at each position. A multiply-add is 2 FLOPs."""
    d, pt = cfg["dim"], cfg["patch"]
    s = (cfg["page_h"] // pt) * (cfg["page_w"] // pt)
    mlp = 4 * d
    enc = 2 * s * pt * pt * d
    enc += cfg["enc_depth"] * (2 * s * 4 * d * d + 2 * 2 * s * s * d + 2 * s * 2 * d * mlp)
    dec = cfg["dec_depth"] * 2 * s * 2 * d * d  # cross-attention keys and values
    for t in range(served):
        per = 2 * 4 * d * d + 2 * 2 * (t + 1) * d  # self-attention, t + 1 keys
        per += 2 * 2 * d * d + 2 * 2 * s * d  # cross-attention: query, out, s keys
        per += 2 * 2 * d * mlp
        dec += cfg["dec_depth"] * per + 2 * d * cfg["vocab"]
    return int(enc + dec)
