"""A decoder-only language model with DeepSeek-V3's block: latent attention
(MLA) and a mixture of experts with a sigmoid router and shared experts.

The sizes come from a Hugging Face ``config.json`` of the family
(``MLAMoEConfig.from_dict``; ``Moonlight-16B-A3B`` is the benchmark's), none
from constants here. The math follows the published
``modeling_deepseek.py`` (DeepSeek-V3), layer by layer:

- RMSNorm: the mean of squares in float32, ``x * rsqrt(ms + eps)`` cast back
  to the compute type, then times the weight;
- attention: ``q_proj`` to ``heads * (nope + rope)``; ``kv_a_proj_with_mqa``
  to the latent (``kv_lora_rank``) and one rope key shared by the heads;
  ``kv_a_layernorm`` on the latent; ``kv_b_proj`` to each head's nope key
  and value; RoPE (theta from the config, no scaling) on the rope parts in
  the published pair layout (``view(..., d / 2, 2).transpose`` before
  ``rotate_half``; cos and sin in the compute type); scores times
  ``(nope + rope) ** -0.5``; softmax in float32, cast back; ``o_proj``;
- the first ``first_k_dense_replace`` layers: a SwiGLU of
  ``intermediate_size``; the others: router logits as ``F.linear`` of
  float32 operands, a sigmoid, the top ``num_experts_per_tok`` of score
  plus ``e_score_correction_bias`` (one group), weighted by the score
  without the bias, normalized to sum 1 (``norm_topk_prob``) and times
  ``routed_scaling_factor``; SwiGLU experts of ``moe_intermediate_size``
  (``kernels/moe_gemm.py``), their outputs weighted and summed in float32,
  cast back, plus a shared SwiGLU of ``n_shared_experts`` times that width;
- a final RMSNorm and an untied head; logits in the compute type, then
  float32.

Departures: the parameters are a flat dictionary under the published names,
but each layer's routed experts are stacked into one tensor a projection
(``mlp.experts.gate_proj`` of (experts, width, hidden), and so on); the
correction bias is stored in the compute type like every other tensor;
prefill attention runs through ``F.scaled_dot_product_attention`` (softmax
over the float32 scores inside it) and the decode step attends in the
latent space, with ``kv_b_proj``'s key half absorbed into the query and its
value half into the output: the same products, rounded elsewhere.

``generate`` prefills the prompts' real tokens packed (padding does no
projection or expert work), writing each row's normalized latent and roped
key into a static cache of ``slots`` positions a row, then decodes one
position a row a step at the row's own position, greedy, with no host sync
in a step; on a card each step replays a CUDA graph (``models/graphed.py``,
shared with the PageReader).
"""

from __future__ import annotations

import hashlib
import weakref
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from bbocr_tpu_torch.kernels import moe_gemm
from bbocr_tpu_torch.models import graphed
from bbocr_tpu_torch.utils import profiling
from bbocr_tpu_torch.utils.profiling import span

FFN_CHUNK = 32768  # prefill tokens a dense or expert layer takes at once (bounds its buffers)


@dataclass(frozen=True)
class MLAMoEConfig:
    vocab_size: int
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    intermediate_size: int
    moe_intermediate_size: int
    n_routed_experts: int
    n_shared_experts: int
    num_experts_per_tok: int
    first_k_dense_replace: int
    routed_scaling_factor: float
    norm_topk_prob: bool
    rope_theta: float
    rms_norm_eps: float
    bos_token_id: int
    eos_token_id: int

    # values the model takes only as given; anything else raises
    FIXED = {
        "q_lora_rank": None, "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
        "moe_layer_freq": 1, "hidden_act": "silu", "tie_word_embeddings": False, "attention_bias": False,
    }

    @classmethod
    def from_dict(cls, d: Dict[str, Any], bos_token_id: int, eos_token_id: int) -> "MLAMoEConfig":
        """From a ``config.json``'s keys; raises on a value this model does not
        compute (query compression, softmax routing, groups, rope scaling)."""
        for key, want in cls.FIXED.items():
            if d.get(key, want) != want:
                raise ValueError(f"{key}={d[key]!r} is not supported (only {want!r})")
        if d.get("rope_scaling") is not None:
            raise ValueError("rope_scaling is not supported")
        if d.get("num_key_value_heads", d["num_attention_heads"]) != d["num_attention_heads"]:
            raise ValueError("latent attention has as many key heads as query heads")
        given = dict(bos_token_id=bos_token_id, eos_token_id=eos_token_id)
        return cls(**{f.name: given[f.name] if f.name in given else d[f.name] for f in fields(cls)})

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace


# ----------------------------------------------------------------------
# Parameters
# ----------------------------------------------------------------------


def param_shapes(cfg: MLAMoEConfig) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Each tensor's name, shape and kind (``embed``, ``out`` for a
    feed-forward branch's output projection, ``normal``, ``norm`` or
    ``bias``), in the order ``init_random`` draws them."""
    h, nh, r, rope = cfg.hidden_size, cfg.num_attention_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {"model.embed_tokens.weight": ((cfg.vocab_size, h), "embed")}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = ((h,), "norm")
        out[p + "self_attn.q_proj.weight"] = ((nh * cfg.qk_head_dim, h), "normal")
        out[p + "self_attn.kv_a_proj_with_mqa.weight"] = ((r + rope, h), "normal")
        out[p + "self_attn.kv_a_layernorm.weight"] = ((r,), "norm")
        out[p + "self_attn.kv_b_proj.weight"] = ((nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), r), "normal")
        out[p + "self_attn.o_proj.weight"] = ((h, nh * cfg.v_head_dim), "normal")
        out[p + "post_attention_layernorm.weight"] = ((h,), "norm")
        if cfg.is_moe(i):
            e, w, s = cfg.n_routed_experts, cfg.moe_intermediate_size, cfg.n_shared_experts * cfg.moe_intermediate_size
            out[p + "mlp.gate.weight"] = ((e, h), "normal")
            out[p + "mlp.gate.e_score_correction_bias"] = ((e,), "bias")
            out[p + "mlp.experts.gate_proj"] = ((e, w, h), "normal")
            out[p + "mlp.experts.up_proj"] = ((e, w, h), "normal")
            out[p + "mlp.experts.down_proj"] = ((e, h, w), "out")
            out[p + "mlp.shared_experts.gate_proj.weight"] = ((s, h), "normal")
            out[p + "mlp.shared_experts.up_proj.weight"] = ((s, h), "normal")
            out[p + "mlp.shared_experts.down_proj.weight"] = ((h, s), "out")
        else:
            out[p + "mlp.gate_proj.weight"] = ((cfg.intermediate_size, h), "normal")
            out[p + "mlp.up_proj.weight"] = ((cfg.intermediate_size, h), "normal")
            out[p + "mlp.down_proj.weight"] = ((h, cfg.intermediate_size), "out")
    out["model.norm.weight"] = ((h,), "norm")
    out["lm_head.weight"] = ((cfg.vocab_size, h), "normal")
    return out


def tensor_seed(seed: int, name: str) -> int:
    """The generator seed of one tensor: the first 8 bytes of SHA-256 of
    ``"<seed>/<name>"``, little-endian, below 2**63."""
    return int.from_bytes(hashlib.sha256(f"{seed}/{name}".encode()).digest()[:8], "little") & (2**63 - 1)


def draw(seed: int, name: str, shape, mean: float, std: float, device, dtype=torch.bfloat16) -> torch.Tensor:
    """``(randn(shape) * std + mean)`` in float32 from the tensor's own
    generator on ``device``, cast to ``dtype``."""
    g = torch.Generator(device=device)
    g.manual_seed(tensor_seed(seed, name))
    return (torch.randn(shape, generator=g, device=device, dtype=torch.float32) * std + mean).to(dtype)


@dataclass(frozen=True)
class InitScales:
    """The random init's scales, by tensor kind (``param_shapes``)."""

    std: float  # attention, the router, the head and every input projection: N(0, std)
    out_std: float  # the feed-forward branches' output projections: N(0, out_std)
    embed_std: float  # the embeddings: N(0, embed_std)
    norm_std: float  # RMSNorm weights: 1 + N(0, norm_std)
    bias_std: float  # the router's correction bias: N(0, bias_std)

    def of(self, kind: str) -> Tuple[float, float]:
        return {"normal": (0.0, self.std), "out": (0.0, self.out_std), "embed": (0.0, self.embed_std),
                "norm": (1.0, self.norm_std), "bias": (0.0, self.bias_std)}[kind]


class MLAMoE:
    """The parameters (``p``, by name, in ``dtype`` on one device) and the
    configuration. Weak-referenceable, so ``generate``'s states die with it."""

    def __init__(self, cfg: MLAMoEConfig, params: Dict[str, torch.Tensor]):
        want = param_shapes(cfg)
        differ = {k: (tuple(params[k].shape) if k in params else None, s) for k, (s, _) in want.items()
                  if k not in params or tuple(params[k].shape) != s}
        if differ or set(params) != set(want):
            raise ValueError(f"parameters do not fit the configuration: {differ or sorted(set(params) - set(want))}")
        self.cfg = cfg
        self.p = params
        first = params["model.embed_tokens.weight"]
        self.dtype, self.device = first.dtype, first.device
        # each layer's tensors by their names within the layer (the same tensors)
        self.layers = [{k.split(".", 3)[3]: v for k, v in params.items() if k.startswith(f"model.layers.{i}.")}
                       for i in range(cfg.num_hidden_layers)]


def init_random(cfg: MLAMoEConfig, seed: int, device, dtype: torch.dtype, scales: InitScales) -> MLAMoE:
    """Random weights from ``seed``: each tensor drawn on ``device`` from its
    own generator (``draw``, seeded by ``tensor_seed(seed, name)``), with
    the mean and deviation ``scales`` give its kind."""
    params = {}
    for name, (shape, kind) in param_shapes(cfg).items():
        params[name] = draw(seed, name, shape, *scales.of(kind), device, dtype)
    return MLAMoE(cfg, params)


@torch.no_grad()
def redraw(model: MLAMoE, seed: int, scales: InitScales) -> None:
    """``init_random``'s weights for ``seed``, drawn into the model's tensors
    in place (a captured step reads them)."""
    for name, (shape, kind) in param_shapes(model.cfg).items():
        model.p[name].copy_(draw(seed, name, shape, *scales.of(kind), model.device, model.dtype))


# ----------------------------------------------------------------------
# Layers
# ----------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return weight * xf.to(x.dtype)


def rope_tables(cfg: MLAMoEConfig, positions: int, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of (positions, rope dim) as the published rotary embedding
    makes them: float32 angles, ``cat(freqs, freqs)``, cast to ``dtype``."""
    d = cfg.qk_rope_head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, d, 2, dtype=torch.int64).float().to(device) / d))
    t = torch.arange(positions, device=device, dtype=torch.float32)
    emb = torch.cat([torch.outer(t, inv_freq)] * 2, dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The published pair layout: (..., d) viewed as (d / 2, 2) pairs and
    transposed, then ``x * cos + rotate_half(x) * sin``; ``cos`` and ``sin``
    broadcast over the dimensions between the first and the last."""
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + rot * sin


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    return F.linear(F.silu(F.linear(x, gate)) * F.linear(x, up), down)


def route(cfg: MLAMoEConfig, x: torch.Tensor, w: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(expert ids (T, k), float32 weights (T, k)) of tokens ``x`` (T, hidden)."""
    scores = F.linear(x.float(), w["mlp.gate.weight"].float()).sigmoid()
    choice = scores + w["mlp.gate.e_score_correction_bias"].float()[None]
    idx = torch.topk(choice, cfg.num_experts_per_tok, dim=-1, sorted=False).indices
    weight = scores.gather(1, idx)
    if cfg.norm_topk_prob:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    return idx, weight * cfg.routed_scaling_factor


def ffn(cfg: MLAMoEConfig, x: torch.Tensor, w: Dict[str, torch.Tensor], load: Optional[torch.Tensor]) -> torch.Tensor:
    """The layer's dense SwiGLU, or its experts: routed (the grouped GEMM)
    plus shared. ``load`` (experts,) gains the pairs each expert took."""
    if "mlp.gate_proj.weight" in w:
        return swiglu(x, w["mlp.gate_proj.weight"], w["mlp.up_proj.weight"], w["mlp.down_proj.weight"])
    idx, weight = route(cfg, x, w)
    if load is not None:
        flat = idx.reshape(-1)
        load.index_add_(0, flat, torch.ones_like(flat))
    y = moe_gemm.routed_experts(x, idx, weight, w["mlp.experts.gate_proj"], w["mlp.experts.up_proj"],
                                w["mlp.experts.down_proj"])
    shared = swiglu(x, w["mlp.shared_experts.gate_proj.weight"], w["mlp.shared_experts.up_proj.weight"],
                    w["mlp.shared_experts.down_proj.weight"])
    return y + shared


def _split_q(cfg: MLAMoEConfig, x: torch.Tensor, w) -> Tuple[torch.Tensor, torch.Tensor]:
    q = F.linear(x, w["self_attn.q_proj.weight"]).view(*x.shape[:-1], cfg.num_attention_heads, cfg.qk_head_dim)
    return q[..., : cfg.qk_nope_head_dim], q[..., cfg.qk_nope_head_dim:]


def _latent(cfg: MLAMoEConfig, x: torch.Tensor, w, cos, sin) -> torch.Tensor:
    """(..., kv_lora_rank + rope): the normalized latent and the roped key,
    as the cache holds them."""
    ckv = F.linear(x, w["self_attn.kv_a_proj_with_mqa.weight"])
    c = rms_norm(ckv[..., : cfg.kv_lora_rank], w["self_attn.kv_a_layernorm.weight"], cfg.rms_norm_eps)
    return torch.cat([c, apply_rope(ckv[..., cfg.kv_lora_rank:], cos, sin)], dim=-1)


# ----------------------------------------------------------------------
# Generation
# ----------------------------------------------------------------------


class LMState(graphed.StepState):
    """Greedy decoding over static buffers for one (model, batch, cache
    slots, new tokens, type, device).

    ``cache`` holds, for each layer, each row's normalized latent and roped
    key at each position: (batch, slots, kv_lora_rank + rope), zeroed once
    (a masked slot's probability is 0, and 0 times a stale finite value is 0).
    ``load`` prefills a call's prompts (``prefill``): it fills the cache up
    to each row's length, puts each row's last logits in ``logits`` and
    their argmax in ``tokens[:, 0]`` (-1 in the other slots) and sets ``pos`` to the lengths, the step index to 0 and
    the expert load to 0. ``step`` then embeds ``tokens[:, t]`` of each row
    at its ``pos``, writes that position's latent and roped key into the
    cache, attends over every slot with ``slot <= pos`` in the latent space,
    puts the argmax of the float32 logits (the first index wins ties) into
    ``tokens[:, t + 1]``, or EOS where the row already holds one, and moves
    ``pos`` and ``t`` on.
    """

    def __init__(self, model: MLAMoE, batch: int, slots: int, new_tokens: int, device: torch.device):
        super().__init__(device)
        cfg = model.cfg
        self.model = weakref.proxy(model)  # the state lives in a table keyed weakly by the model
        self.cache = [torch.zeros(batch, slots, cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype=model.dtype,
                                  device=device) for _ in range(cfg.num_hidden_layers)]
        self.cos, self.sin = rope_tables(cfg, slots, model.dtype, device)
        self.tokens = torch.zeros(batch, new_tokens, dtype=torch.int64, device=device)
        self.logits = torch.zeros(batch, cfg.vocab_size, device=device)
        self.pos = torch.zeros(batch, dtype=torch.int64, device=device)
        self.t = torch.zeros((), dtype=torch.int64, device=device)
        self.rows = torch.arange(batch, device=device)
        self.slots = torch.arange(slots, device=device)
        self.eos = torch.full((), cfg.eos_token_id, dtype=torch.int64, device=device)
        n_moe = sum(cfg.is_moe(i) for i in range(cfg.num_hidden_layers))
        self.load_count = torch.zeros(n_moe, cfg.n_routed_experts, dtype=torch.int64, device=device)
        self.scale = torch.full((), cfg.qk_head_dim ** -0.5, device=device)

    def _expert_load(self, i: int) -> torch.Tensor:
        return self.load_count[i - self.model.cfg.first_k_dense_replace]

    def load(self, prompt_ids: torch.Tensor, lengths: torch.Tensor) -> int:
        """Prefill; returns the real tokens that went through the layers."""
        self.t.zero_()
        self.load_count.zero_()
        self.tokens.fill_(-1)
        self.pos.copy_(lengths)
        logits, n = prefill(self.model, prompt_ids, lengths, self)
        self.logits.copy_(logits)
        self.tokens[:, 0] = torch.argmax(logits, dim=-1)
        return n

    def step(self) -> None:
        m = self.model
        cfg, p = m.cfg, m.p
        nh, r = cfg.num_attention_heads, cfg.kv_lora_rank
        at = self.t.view(1)
        cur = self.tokens.index_select(1, at)[:, 0]
        x = p["model.embed_tokens.weight"][cur]  # (B, hidden)
        cos, sin = self.cos[self.pos][:, None], self.sin[self.pos][:, None]
        masked = (self.slots[None, :] > self.pos[:, None])[:, None, :]  # (B, 1, slots)
        for i, cache in enumerate(self.cache):
            w = m.layers[i]
            h = rms_norm(x, w["input_layernorm.weight"], cfg.rms_norm_eps)
            q_nope, q_pe = _split_q(cfg, h, w)
            cache.index_put_((self.rows, self.pos), _latent(cfg, h, w, cos[:, 0], sin[:, 0]))
            kv_b = w["self_attn.kv_b_proj.weight"].view(nh, cfg.qk_nope_head_dim + cfg.v_head_dim, r)
            w_uk, w_uv = kv_b[:, : cfg.qk_nope_head_dim], kv_b[:, cfg.qk_nope_head_dim:]
            q_lat = torch.bmm(q_nope.transpose(0, 1), w_uk).transpose(0, 1)  # (B, heads, r)
            qf = torch.cat([q_lat, apply_rope(q_pe, cos, sin)], dim=-1)
            s = torch.bmm(qf, cache.transpose(1, 2)).float() * self.scale
            prob = torch.softmax(s.masked_fill(masked, float("-inf")), dim=-1).to(x.dtype)
            o_lat = torch.bmm(prob, cache[..., :r])  # (B, heads, r)
            o = torch.bmm(o_lat.transpose(0, 1), w_uv.transpose(1, 2)).transpose(0, 1)  # (B, heads, v)
            x = x + F.linear(o.reshape(x.shape[0], -1), w["self_attn.o_proj.weight"])
            h = rms_norm(x, w["post_attention_layernorm.weight"], cfg.rms_norm_eps)
            x = x + ffn(cfg, h, w, self._expert_load(i) if cfg.is_moe(i) else None)
        self.logits.copy_(head_logits(m, x))
        nxt = torch.argmax(self.logits, dim=-1)
        done = torch.any(self.tokens == self.eos, dim=1)
        self.tokens.index_copy_(1, at + 1, torch.where(done, self.eos, nxt)[:, None])
        self.pos += 1
        self.t += 1


def head_logits(m: MLAMoE, x: torch.Tensor) -> torch.Tensor:
    cfg, p = m.cfg, m.p
    return F.linear(rms_norm(x, p["model.norm.weight"], cfg.rms_norm_eps), p["lm_head.weight"]).float()


def prefill(m: MLAMoE, prompt_ids: torch.Tensor, lengths: torch.Tensor, state: LMState) -> Tuple[torch.Tensor, int]:
    """The prompts' real tokens, packed, through every layer: each row's
    latent and roped keys into ``state.cache`` (and its expert load), causal
    attention within each row over keys and values expanded per head;
    returns (each row's float32 logits at its last token, the real tokens)."""
    cfg, p = m.cfg, m.p
    nh, nope, v_dim = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    b, width = prompt_ids.shape
    real = torch.arange(width, device=prompt_ids.device)[None, :] < lengths[:, None]
    rows, pos = real.nonzero(as_tuple=True)
    n = rows.numel()
    with span("lm.prefill", tokens=n):
        x = p["model.embed_tokens.weight"][prompt_ids[rows, pos]]  # (T, hidden)
        cos, sin = state.cos[pos], state.sin[pos]
        for i, cache in enumerate(state.cache):
            w = m.layers[i]
            h = rms_norm(x, w["input_layernorm.weight"], cfg.rms_norm_eps)
            q_nope, q_pe = _split_q(cfg, h, w)
            lat = _latent(cfg, h, w, cos, sin)  # (T, r + rope)
            cache.index_put_((rows, pos), lat)
            kv = F.linear(lat[:, : cfg.kv_lora_rank], w["self_attn.kv_b_proj.weight"]).view(n, nh, nope + v_dim)
            k_pe = lat[:, None, cfg.kv_lora_rank:].expand(n, nh, cfg.qk_rope_head_dim)
            q = torch.cat([q_nope, apply_rope(q_pe, cos[:, None], sin[:, None])], dim=-1)
            k = torch.cat([kv[..., :nope], k_pe], dim=-1)
            # rows padded to the widest prompt: right padding under a causal
            # mask leaves every real query's keys real; V padded to the
            # query's width, as the fused attention takes one head size
            qp, kp, vp = (x.new_zeros(b, width, nh, cfg.qk_head_dim) for _ in range(3))
            qp[rows, pos], kp[rows, pos], vp[rows, pos, :, :v_dim] = q, k, kv[..., nope:]
            o = F.scaled_dot_product_attention(qp.transpose(1, 2), kp.transpose(1, 2), vp.transpose(1, 2),
                                               is_causal=True, scale=cfg.qk_head_dim ** -0.5)
            o = o.transpose(1, 2)[rows, pos, :, :v_dim].reshape(n, nh * v_dim)
            x = x + F.linear(o, w["self_attn.o_proj.weight"])
            h = rms_norm(x, w["post_attention_layernorm.weight"], cfg.rms_norm_eps)
            load = state._expert_load(i) if cfg.is_moe(i) else None
            x = x + torch.cat([ffn(cfg, c, w, load) for c in h.split(FFN_CHUNK)])
        last = torch.cumsum(lengths, 0) - 1
        return head_logits(m, x[last]), n


# model -> {(batch, slots, new tokens, dtype, device): LMState} (``graphed.state_for``)
_STATES: "weakref.WeakKeyDictionary[MLAMoE, Dict[tuple, LMState]]" = weakref.WeakKeyDictionary()


def load_balance(counts: torch.Tensor) -> float:
    """Mean over the expert layers of the most-loaded expert's pairs over
    the mean expert's."""
    c = counts.double()
    return float((c.max(1).values / c.mean(1).clamp_min(1e-12)).mean())


@torch.no_grad()
def generate(model: MLAMoE, prompt_ids: torch.Tensor, lengths: torch.Tensor, new_tokens: int,
             slots: Optional[int] = None) -> torch.Tensor:
    """Greedy (B, ``new_tokens``) ids after right-padded prompts (B, width)
    of ``lengths`` real tokens each: the prefill's argmax, then
    ``new_tokens - 1`` decode steps; a row that holds EOS keeps emitting
    EOS. ``slots`` (at least width + new tokens; that by default) sizes the
    cache, so that calls of one batch size share one graph whatever their
    widths. On a CUDA device each step replays a graph captured at the first
    call per model, batch, slots, new tokens, type and device. Spans (when
    recording): ``lm.generate`` for the call, a batch of its own
    (``requests``, ``prompt_tokens``, ``new_tokens``, and after the call
    ``expert_load_max_over_mean``, ``load_balance`` of the call's pairs
    per expert), ``lm.prefill`` (``tokens``), one ``lm.step`` a step."""
    b, width = prompt_ids.shape
    slots = slots or width + new_tokens
    if slots < width + new_tokens - 1:
        raise ValueError(f"{slots} cache slots hold no {width}-token prompt and {new_tokens} new tokens")
    lengths = lengths.to(prompt_ids.device, torch.int64)
    with profiling.batch(), span("lm.generate", requests=b, new_tokens=new_tokens) as sp:
        is_cuda = prompt_ids.device.type == "cuda"
        key = (b, slots, new_tokens, model.dtype, prompt_ids.device)
        make = lambda: LMState(model, b, slots, new_tokens, prompt_ids.device)  # noqa: E731
        state = graphed.state_for(_STATES, model, key, make) if is_cuda else make()
        with state.lock:
            real: List[int] = []
            graphed.run_steps(state, new_tokens - 1, lambda: real.append(state.load(prompt_ids, lengths)),
                              is_cuda, "lm.step")
            if sp is not None:
                sp.attrs.update(prompt_tokens=real[-1], expert_load_max_over_mean=load_balance(state.load_count))
            return state.tokens.clone()
