"""Plain reference of ``moonlight_16b_a3b`` and the judge of its served tokens.

DeepSeek-V3's decoder block as the published ``modeling_deepseek.py``
writes it, at the sizes of the configuration file: RMSNorm, latent
attention (MLA) with no query compression, decoupled RoPE on the 64-dim
parts in the published pair layout, a dense SwiGLU first layer, then
mixtures of experts with a sigmoid router whose top-k is chosen on score
plus ``e_score_correction_bias`` and weighted by the normalized score times
``routed_scaling_factor``, two shared experts; a final RMSNorm and an
untied head. Plain PyTorch in float32 (TF32 off: ``lowp.precise_matmuls``),
naive MLA (keys and values expanded per head), no cache, no batching: each
sequence is its own full causal forward. It imports nothing of the program.

The weights are drawn by the configuration's rule (``assumed.init``): each
tensor from its own ``torch.Generator`` on the run's device, seeded by the
first 8 bytes (little-endian, below 2**63) of SHA-256 of ``"<seed>/<name>"``,
as ``randn(shape) * std + mean`` in float32, rounded to the configuration's
``dtype`` (the type the program stores) and taken back to float32; the mean
and deviation by the tensor's kind (the embeddings, the output projections
of the feed-forward branches, the other matrices, the RMSNorm weights, the
correction bias). The routed experts of a layer are one tensor a
projection, (experts, width, hidden) and (experts, hidden, width). They are
drawn layer by layer, so that the reference holds one layer beside its
activations.

``token_gap``: over the served positions of the judged requests, the widest
gap by which a served token's logit lies below the reference's best logit
at its position (teacher-forced on the served tokens); ``token_gap_mean``:
the mean of those gaps. A routing flip (a score at the top-k's edge that
rounding moves across it) moves a token's logits by itself, and any
rounding makes some, so the widest gap is set by the flips and the mean by
how many there are. The control reads, at the same positions, the gap of
the token that the reference computed with float8 operands (``lowp.fp8``
on both operands of every product) puts first.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Q = Callable[[torch.Tensor], torch.Tensor]


def _exact(x: torch.Tensor) -> torch.Tensor:
    return x


# ----------------------------------------------------------------------
# The weights
# ----------------------------------------------------------------------


def layer_shapes(cfg: Dict, i: int) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Layer ``i``'s tensors: name within the layer -> (shape, kind: ``out``
    for the output projection of a feed-forward branch, ``normal``, ``norm``
    or ``bias``)."""
    h, nh, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    out = {
        "input_layernorm.weight": ((h,), "norm"),
        "self_attn.q_proj.weight": ((nh * (nope + rope), h), "normal"),
        "self_attn.kv_a_proj_with_mqa.weight": ((r + rope, h), "normal"),
        "self_attn.kv_a_layernorm.weight": ((r,), "norm"),
        "self_attn.kv_b_proj.weight": ((nh * (nope + v), r), "normal"),
        "self_attn.o_proj.weight": ((h, nh * v), "normal"),
        "post_attention_layernorm.weight": ((h,), "norm"),
    }
    if i >= cfg["first_k_dense_replace"]:
        e, w = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        s = cfg["n_shared_experts"] * w
        out.update({
            "mlp.gate.weight": ((e, h), "normal"),
            "mlp.gate.e_score_correction_bias": ((e,), "bias"),
            "mlp.experts.gate_proj": ((e, w, h), "normal"),
            "mlp.experts.up_proj": ((e, w, h), "normal"),
            "mlp.experts.down_proj": ((e, h, w), "out"),
            "mlp.shared_experts.gate_proj.weight": ((s, h), "normal"),
            "mlp.shared_experts.up_proj.weight": ((s, h), "normal"),
            "mlp.shared_experts.down_proj.weight": ((h, s), "out"),
        })
    else:
        d = cfg["intermediate_size"]
        out.update({
            "mlp.gate_proj.weight": ((d, h), "normal"),
            "mlp.up_proj.weight": ((d, h), "normal"),
            "mlp.down_proj.weight": ((h, d), "out"),
        })
    return out


def draw(cfg: Dict, seed: int, name: str, shape, kind: str, device) -> torch.Tensor:
    """One tensor by the configuration's rule, rounded to its ``dtype`` and
    back to float32."""
    init = cfg["assumed"]["init"]
    mean, std = {"normal": (0.0, init["std"]), "out": (0.0, init["out_std"]), "embed": (0.0, init["embed_std"]),
                 "norm": (1.0, init["norm_std"]), "bias": (0.0, init["bias_std"])}[kind]
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(hashlib.sha256(f"{seed}/{name}".encode()).digest()[:8], "little") & (2**63 - 1))
    x = torch.randn(shape, generator=g, device=device, dtype=torch.float32) * std + mean
    return x.to(getattr(torch, cfg["dtype"])).float()


def draw_layer(cfg: Dict, seed: int, i: int, device) -> Dict[str, torch.Tensor]:
    pre = f"model.layers.{i}."
    return {k: draw(cfg, seed, pre + k, s, kind, device) for k, (s, kind) in layer_shapes(cfg, i).items()}


# ----------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def linear(x: torch.Tensor, w: torch.Tensor, q: Q) -> torch.Tensor:
    return torch.matmul(q(x), q(w).t())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE over the positions 0.. of x (seq, ..., d): pairs de-interleaved
    (``view(d / 2, 2).transpose``), then ``x * cos + rotate_half(x) * sin``."""
    s, d = x.shape[0], x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.int64).float().to(x.device) / d))
    freqs = torch.outer(torch.arange(s, device=x.device, dtype=torch.float32), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    shape = (s,) + (1,) * (x.dim() - 2) + (d,)
    cos, sin = emb.cos().view(shape), emb.sin().view(shape)
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + rot * sin


def attention(cfg: Dict, x: torch.Tensor, w: Dict, q: Q) -> torch.Tensor:
    """Causal MLA over one sequence x (seq, hidden), keys and values expanded."""
    s = x.shape[0]
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rp, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    qh = linear(x, w["self_attn.q_proj.weight"], q).view(s, nh, nope + rp)
    ckv = linear(x, w["self_attn.kv_a_proj_with_mqa.weight"], q)
    c = rms_norm(ckv[:, :r], w["self_attn.kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    k_pe = rope(ckv[:, None, r:], cfg["rope_theta"])  # (seq, 1, rope), shared by the heads
    kv = linear(c, w["self_attn.kv_b_proj.weight"], q).view(s, nh, nope + vd)
    query = torch.cat([qh[..., :nope], rope(qh[..., nope:], cfg["rope_theta"])], dim=-1).transpose(0, 1)
    key = torch.cat([kv[..., :nope], k_pe.expand(s, nh, rp)], dim=-1).transpose(0, 1)
    value = kv[..., nope:].transpose(0, 1)
    scores = torch.matmul(q(query), q(key).transpose(1, 2)) * (nope + rp) ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    prob = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.matmul(q(prob), q(value)).transpose(0, 1).reshape(s, nh * vd)
    return linear(o, w["self_attn.o_proj.weight"], q)


def swiglu(x: torch.Tensor, gate, up, down, q: Q) -> torch.Tensor:
    return linear(torch.nn.functional.silu(linear(x, gate, q)) * linear(x, up, q), down, q)


def route(cfg: Dict, x: torch.Tensor, w: Dict, q: Q) -> Tuple[torch.Tensor, torch.Tensor]:
    """(experts (T, k), weights (T, k)) of tokens x (T, hidden)."""
    scores = torch.sigmoid(linear(x, w["mlp.gate.weight"], q))
    chosen = torch.topk(scores + w["mlp.gate.e_score_correction_bias"][None], cfg["num_experts_per_tok"], dim=-1).indices
    weight = scores.gather(1, chosen)
    if cfg["norm_topk_prob"]:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    return chosen, weight * cfg["routed_scaling_factor"]


def experts(cfg: Dict, x: torch.Tensor, w: Dict, q: Q) -> torch.Tensor:
    """The routed experts, token by expert, plus the shared ones."""
    chosen, weight = route(cfg, x, w, q)
    out = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], w["mlp.experts.gate_proj"][e], w["mlp.experts.up_proj"][e],
                       w["mlp.experts.down_proj"][e], q)
            out.index_add_(0, tok, y * weight[tok, slot][:, None])
    return out + swiglu(x, w["mlp.shared_experts.gate_proj.weight"], w["mlp.shared_experts.up_proj.weight"],
                        w["mlp.shared_experts.down_proj.weight"], q)


def ffn(cfg: Dict, x: torch.Tensor, w: Dict, q: Q) -> torch.Tensor:
    if "mlp.gate_proj.weight" in w:
        return swiglu(x, w["mlp.gate_proj.weight"], w["mlp.up_proj.weight"], w["mlp.down_proj.weight"], q)
    return experts(cfg, x, w, q)


@torch.no_grad()
def forward_logits(cfg: Dict, seed: int, seqs: Sequence[torch.Tensor], at: Sequence[torch.Tensor],
                   qs: Sequence[Q], device) -> List[List[torch.Tensor]]:
    """For each operand rounding in ``qs``, each sequence's float32 logits
    (len(at[j]), vocab) at the positions ``at[j]`` of a full causal forward
    over ``seqs[j]`` (token ids on ``device``), layer by layer, the layer's
    weights drawn once for every rounding."""
    eps = cfg["rms_norm_eps"]
    embed = draw(cfg, seed, "model.embed_tokens.weight", (cfg["vocab_size"], cfg["hidden_size"]), "embed", device)
    xs = [[embed[s] for s in seqs] for _ in qs]
    del embed
    for i in range(cfg["num_hidden_layers"]):
        w = draw_layer(cfg, seed, i, device)
        for q, rows in zip(qs, xs):
            for j, x in enumerate(rows):
                x = x + attention(cfg, rms_norm(x, w["input_layernorm.weight"], eps), w, q)
                rows[j] = x + ffn(cfg, rms_norm(x, w["post_attention_layernorm.weight"], eps), w, q)
        del w
    norm = draw(cfg, seed, "model.norm.weight", (cfg["hidden_size"],), "norm", device)
    head = draw(cfg, seed, "lm_head.weight", (cfg["vocab_size"], cfg["hidden_size"]), "normal", device)
    return [[linear(rms_norm(x[a], norm, eps), head, q) for x, a in zip(rows, at)] for q, rows in zip(qs, xs)]


def served_length(row: np.ndarray, eos: int) -> int:
    """Tokens up to and including the first EOS (the whole row without one)."""
    hits = np.nonzero(row == eos)[0]
    return int(hits[0]) + 1 if len(hits) else len(row)


class LMReference:
    def __init__(self, config: Dict, seed: int, device):
        self.cfg, self.seed, self.device = config, seed, device

    def gaps(self, prompts: Sequence[np.ndarray], served: Sequence[np.ndarray],
             q_first: Optional[Q] = None) -> Tuple[float, float, int]:
        """(widest gap, mean gap, positions judged) over requests: each prompt's real
        ids and its served ids, judged up to the first EOS (the assumed
        ``eos_token_id``). With ``q_first`` the gap is that of the token the
        model computed with ``q_first`` puts first, at the same positions."""
        eos = self.cfg["assumed"]["eos_token_id"]
        seqs, at, n = [], [], []
        for prompt, row in zip(prompts, served):
            k = served_length(np.asarray(row), eos)
            ids = np.concatenate([np.asarray(prompt), np.asarray(row)[: k - 1]]).astype(np.int64)
            seqs.append(torch.from_numpy(ids).to(self.device))
            at.append(torch.arange(len(prompt) - 1, len(prompt) - 1 + k, device=self.device))
            n.append(k)
        qs = [_exact] if q_first is None else [_exact, q_first]
        logits = forward_logits(self.cfg, self.seed, seqs, at, qs, self.device)
        gaps = []
        for j, (row, k) in enumerate(zip(served, n)):
            exact = logits[0][j]
            pick = torch.from_numpy(np.asarray(row)[:k].astype(np.int64)).to(self.device)
            if q_first is not None:
                pick = logits[1][j].argmax(-1)
            gaps.append(exact.max(-1).values - exact.gather(1, pick[:, None])[:, 0])
        every = torch.cat(gaps)
        return float(every.max()), float(every.mean()), int(every.numel())


# ----------------------------------------------------------------------
# Operations and bytes: the benchmark's yardstick
# ----------------------------------------------------------------------


def _token_flops(cfg: Dict, layer: int, ctx: int) -> int:
    """FLOPs of one token through layer ``layer`` attending over ``ctx``
    keys, naive MLA (a multiply-add is 2 FLOPs)."""
    h, nh, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rp, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    f = 2 * h * nh * (nope + rp) + 2 * h * (r + rp) + 2 * r * nh * (nope + vd) + 2 * nh * vd * h
    f += 2 * nh * (nope + rp) * ctx + 2 * nh * vd * ctx
    if layer >= cfg["first_k_dense_replace"]:
        w = cfg["moe_intermediate_size"]
        f += 2 * h * cfg["n_routed_experts"] + (cfg["num_experts_per_tok"] + cfg["n_shared_experts"]) * 6 * h * w
    else:
        f += 6 * h * cfg["intermediate_size"]
    return f


def request_flops(cfg: Dict, prompt: int, served: int) -> int:
    """FLOPs of one request: a forward over its ``prompt`` tokens and the
    ``served - 1`` it feeds back, each attending over the positions up to
    its own, and the head at the ``served`` positions that emit a token."""
    layers = cfg["num_hidden_layers"]
    moe = layers - cfg["first_k_dense_replace"]
    pos = prompt + served - 1
    per_ctx = _token_flops(cfg, layers - 1, 1) - _token_flops(cfg, layers - 1, 0)  # the same in every layer
    fixed = moe * _token_flops(cfg, layers - 1, 0) + (layers - moe) * _token_flops(cfg, 0, 0)
    return int(pos * fixed + layers * per_ctx * pos * (pos + 1) // 2 + served * 2 * cfg["hidden_size"] * cfg["vocab_size"])


def expert_gemm_cost(cfg: Dict, tokens: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the routed experts' GEMMs in one forward of
    ``tokens`` tokens, over every expert layer: the three products of each
    token-expert pair; each input byte read once and each output byte
    written once: the weights of the experts that some pair touches
    (expected under even routing, E * (1 - (1 - k / E) ** tokens)), the
    tokens in and one output row a pair."""
    h, w = cfg["hidden_size"], cfg["moe_intermediate_size"]
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    moe = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    size = np.dtype(np.float16).itemsize if cfg["dtype"] in ("bfloat16", "float16") else 4
    flops = moe * 2.0 * tokens * k * 3 * h * w
    touched = e * (1.0 - (1.0 - k / e) ** tokens)
    byts = moe * size * (touched * 3 * h * w + tokens * h + tokens * k * h)
    return flops, byts


def roofline_s(cfg: Dict, tokens: int, peak_flops: float, peak_bytes: float) -> float:
    flops, byts = expert_gemm_cost(cfg, tokens)
    return max(flops / peak_flops, byts / peak_bytes)


def params(cfg: Dict) -> int:
    total = 2 * cfg["vocab_size"] * cfg["hidden_size"] + cfg["hidden_size"]
    for i in range(cfg["num_hidden_layers"]):
        total += sum(math.prod(s) for s, _ in layer_shapes(cfg, i).values())
    return total
