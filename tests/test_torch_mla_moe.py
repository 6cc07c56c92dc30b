"""The MLA/MoE language model (``models/mla_moe.py``) and its expert kernel
(``kernels/moe_gemm.py``) against the plain reference of the benchmark's
``moonlight_16b_a3b`` configuration, loaded by path, at a small size with
seeded random weights: hidden 64, 4 heads, a latent of 32, rope 16, 8
experts with 2 a token and 1 shared, 3 layers of which the first is dense.
The tests marked ``gpu`` run on a card only."""

import json
import os

import numpy as np
import pytest
import torch

from bbocr_tpu_torch.kernels import moe_gemm
from bbocr_tpu_torch.models import mla_moe
from bbocr_tpu_torch.utils import profiling
from portbench.core import registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = registry.load_module(os.path.join(ROOT, "portbench", "configs", "moonlight_16b_a3b_reference.py"),
                           "moonlight_reference_under_test")
FILE = os.path.join(ROOT, "portbench", "configs", "moonlight_16b_a3b.json")
SEED = 20261019123  # above 32 bits, as the benchmark's seeds are

SMALL = dict(
    vocab_size=256, hidden_size=64, num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16, intermediate_size=128,
    moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
    first_k_dense_replace=1, routed_scaling_factor=2.446, norm_topk_prob=True, rope_theta=50000,
    rms_norm_eps=1e-5, q_lora_rank=None, scoring_func="sigmoid", topk_method="noaux_tc", n_group=1,
    topk_group=1, moe_layer_freq=1, hidden_act="silu", tie_word_embeddings=False, attention_bias=False,
)
# the benchmark's rule at this size: each layer's gain as at 2048 wide
# (0.02 * sqrt(2048 / 64)), feed-forward output projections over sqrt(2 * layers)
INIT = {"std": 0.113, "out_std": 0.113 / 6 ** 0.5, "embed_std": 1.0, "norm_std": 0.1, "bias_std": 0.05}
BOS, EOS = 254, 255


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def ref_config(dtype: str, **over) -> dict:
    d = dict(SMALL, **over)
    d["dtype"] = dtype
    d["assumed"] = {"init": INIT, "bos_token_id": BOS, "eos_token_id": EOS}
    return d


def build(dtype=torch.float32, device="cpu", seed=SEED, **over):
    d = ref_config(str(dtype).replace("torch.", ""), **over)
    cfg = mla_moe.MLAMoEConfig.from_dict(d, BOS, EOS)
    return mla_moe.init_random(cfg, seed, torch.device(device), dtype, mla_moe.InitScales(**INIT)), d


def prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    rows = [np.concatenate([[BOS], rng.integers(0, BOS, n - 1)]) for n in lengths]
    ids = np.zeros((len(rows), max(lengths)), np.int64)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
    return rows, torch.from_numpy(ids), torch.tensor(lengths)


def cached_steps(model, ids, lengths, new, slots=None):
    """(tokens (B, new), float32 logits (B, new, vocab)): the prefill, then
    ``LMState.step`` run eagerly."""
    b, width = ids.shape
    state = mla_moe.LMState(model, b, slots or width + new, new, ids.device)
    state.load(ids.to(ids.device), lengths.to(ids.device))
    logits = [state.logits.clone()]
    for _ in range(new - 1):
        state.step()
        logits.append(state.logits.clone())
    return state.tokens.clone(), torch.stack(logits, 1)


def reference_logits(d, rows, tokens, new, seed=SEED):
    seqs = [torch.from_numpy(np.concatenate([r, t[:-1]]).astype(np.int64)) for r, t in zip(rows, tokens.numpy())]
    at = [torch.arange(len(r) - 1, len(r) - 1 + new) for r in rows]
    return torch.stack(REF.forward_logits(d, seed, seqs, at, [lambda x: x], torch.device("cpu"))[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_then_cached_decode_follows_the_reference(dtype):
    """Ragged prompts in one batch, prefilled packed, then absorbed-MLA
    decode steps over the latent cache, against the reference's full
    forward over prompt and served tokens at every served position."""
    model, d = build(dtype)
    rows, ids, lengths = prompts([7, 12, 3, 9])
    new = 8
    tokens, logits = cached_steps(model, ids, lengths, new)
    want = reference_logits(d, rows, tokens, new)
    gap = float((logits - want).abs().max())
    if dtype == torch.float32:
        # the same float32 products summed in another order (packed GEMMs,
        # the fused attention, the key half of kv_b absorbed into the query):
        # 1.1e-6 here, 1.0e-6 on the card; at full size 4.0e-4 on the card
        assert gap < 1e-4, gap
        assert torch.equal(tokens, want.argmax(-1))
    else:
        # every product and norm rounded to bfloat16 over 3 layers, against
        # float32 on the same rounded weights: logits of 0.92 spread move by
        # a few hundredths (0.028 here, 0.023 on the card)
        assert gap < 0.05, gap
    assert torch.equal(tokens, mla_moe.generate(model, ids, lengths, new))


def test_ragged_rows_read_as_each_row_alone():
    """A row's ids and logits in a batch of other lengths (padded to the
    widest, a cache wider than it needs) are those it gets alone."""
    model, _ = build()
    _, ids, lengths = prompts([11, 2, 6])
    tokens, logits = cached_steps(model, ids, lengths, 5, slots=40)
    for i in range(3):
        alone, alone_logits = cached_steps(model, ids[i : i + 1, : lengths[i]], lengths[i : i + 1], 5)
        assert torch.equal(alone[0], tokens[i])
        assert float((alone_logits[0] - logits[i]).abs().max()) < 1e-5  # GEMMs of other row counts


def test_the_router_selects_on_the_bias_and_weights_without_it():
    model, d = build()
    cfg = model.cfg
    w = dict(model.layers[1])
    x = torch.randn(50, cfg.hidden_size, generator=torch.Generator().manual_seed(1))
    idx, weight = mla_moe.route(cfg, x, w)
    scores = torch.sigmoid(x @ w["mlp.gate.weight"].t())
    # weights: the chosen scores (no bias), normalized to 1, times the scale
    assert torch.allclose(weight.sum(-1), torch.full((50,), cfg.routed_scaling_factor), atol=1e-5)
    assert torch.allclose(weight, scores.gather(1, idx) / scores.gather(1, idx).sum(-1, keepdim=True)
                          * cfg.routed_scaling_factor, atol=1e-6)
    # selection: the top-k of score plus bias, which differs from the top-k of score alone
    want = torch.topk(scores + w["mlp.gate.e_score_correction_bias"], cfg.num_experts_per_tok).indices
    assert torch.equal(idx.sort(-1).values, want.sort(-1).values)
    plain = torch.topk(scores, cfg.num_experts_per_tok).indices
    assert not torch.equal(idx.sort(-1).values, plain.sort(-1).values)
    w["mlp.gate.e_score_correction_bias"] = torch.zeros_like(w["mlp.gate.e_score_correction_bias"])
    idx0, weight0 = mla_moe.route(cfg, x, w)
    same = (idx0.sort(-1).values == idx.sort(-1).values).all(-1)
    assert torch.allclose(weight0.sort(-1).values[same], weight.sort(-1).values[same], atol=1e-6)
    # the reference routes the same way
    ridx, rweight = REF.route(d, x, w, lambda t: t)
    assert torch.equal(ridx.sort(-1).values, idx0.sort(-1).values) and torch.allclose(rweight, weight0, atol=1e-6)


def _dense_experts(x, idx, weight, gate, up, down):
    """Every expert on every token, masked by the routing: the layer reckoned densely."""
    e = gate.shape[0]
    all_out = torch.stack([torch.nn.functional.linear(
        torch.nn.functional.silu(x @ gate[j].t()) * (x @ up[j].t()), down[j]) for j in range(e)], 1)
    mix = torch.zeros(x.shape[0], e).scatter_(1, idx, weight)
    return (all_out * mix[..., None]).sum(1)


def test_plain_expert_loop_equals_a_dense_reckoning():
    model, _ = build()
    w = model.layers[2]
    g = torch.Generator().manual_seed(3)
    x = torch.randn(37, model.cfg.hidden_size, generator=g)
    idx, weight = mla_moe.route(model.cfg, x, w)
    args = (w["mlp.experts.gate_proj"], w["mlp.experts.up_proj"], w["mlp.experts.down_proj"])
    before = moe_gemm.routed_experts_plain.launches
    got = moe_gemm.routed_experts(x, idx, weight, *args)
    assert moe_gemm.routed_experts_plain.launches == before + 1
    assert torch.allclose(got, _dense_experts(x, idx, weight, *args), atol=1e-6)


@pytest.mark.parametrize("bm", [32, 128])
def test_pairs_align_into_expert_blocks(bm):
    """The kernels' input, made on the device in plain PyTorch: every pair
    in one padded row, in a block of its own expert, each expert's pairs in
    their order; a block holds some pair exactly where it names an expert,
    and the shapes follow from the pair count alone."""
    g = torch.Generator().manual_seed(5)
    e, k, t = 8, 2, 37
    idx = (torch.rand(t, e, generator=g) + torch.linspace(0, 0.5, e)).topk(k).indices
    pair_of_row, tile_e = moe_gemm._align(idx, e, bm)
    p = t * k
    assert pair_of_row.numel() == tile_e.numel() * bm == -(-(p + e * (bm - 1)) // bm) * bm
    real = (pair_of_row < p).nonzero()[:, 0]
    assert torch.equal(pair_of_row[real].sort().values, torch.arange(p))
    flat = idx.reshape(-1)
    assert torch.equal(tile_e[real // bm], flat[pair_of_row[real]])
    for j in range(e):
        assert torch.equal(pair_of_row[real][flat[pair_of_row[real]] == j], (flat == j).nonzero()[:, 0])
    holds = torch.zeros(tile_e.numel(), dtype=torch.bool).index_fill_(0, real // bm, True)
    assert torch.equal(holds, tile_e < e) and bool((tile_e[1:] >= tile_e[:-1]).all())


def test_weights_are_drawn_by_the_configuration_rule():
    """The program's tensors are the reference's draws (rounded alike), and
    another seed gives others."""
    model, d = build(torch.bfloat16)
    for name in ("model.layers.1.mlp.experts.down_proj", "model.layers.2.self_attn.kv_a_layernorm.weight",
                 "model.layers.1.mlp.gate.e_score_correction_bias", "lm_head.weight"):
        shape, kind = mla_moe.param_shapes(model.cfg)[name]
        assert torch.equal(model.p[name].float(), REF.draw(d, SEED, name, shape, kind, "cpu")), name
    other, _ = build(torch.bfloat16, seed=SEED + 1)
    assert not torch.equal(other.p["lm_head.weight"], model.p["lm_head.weight"])
    bias = model.p["model.layers.1.mlp.gate.e_score_correction_bias"]
    assert float(bias.abs().min()) > 0 and abs(float(bias.float().std()) - INIT["bias_std"]) < 0.05


def test_the_configuration_file_builds_moonlight():
    """The benchmark's file: the catalog's keys, a model of those sizes
    (built on the meta device: the constructor holds every tensor to
    ``param_shapes``), 15.96 B parameters; the driver's check of the model
    against the file raises on a value the program does not take."""
    import dataclasses

    with open(FILE) as f:
        d = json.load(f)
    a = d["assumed"]
    cfg = mla_moe.MLAMoEConfig.from_dict(d, a["bos_token_id"], a["eos_token_id"])
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)} == dict(
        {k: d[k] for k in (f.name for f in dataclasses.fields(cfg)) if k in d},
        bos_token_id=a["bos_token_id"], eos_token_id=a["eos_token_id"])
    params = {k: torch.empty(s, dtype=torch.bfloat16, device="meta") for k, (s, _) in mla_moe.param_shapes(cfg).items()}
    model = mla_moe.MLAMoE(cfg, params)
    assert tuple(model.p["model.layers.1.mlp.experts.gate_proj"].shape) == (64, 1408, 2048)
    assert tuple(model.p["model.layers.0.mlp.gate_proj.weight"].shape) == (11264, 2048)
    assert tuple(model.p["model.layers.26.self_attn.kv_a_proj_with_mqa.weight"].shape) == (576, 2048)
    short = dict(params)
    short["model.layers.1.mlp.experts.gate_proj"] = torch.empty(64, 1408, 1024, device="meta")
    with pytest.raises(ValueError, match="do not fit"):
        mla_moe.MLAMoE(cfg, short)
    assert REF.params(d) == sum(int(np.prod(s)) for s, _ in mla_moe.param_shapes(cfg).values())
    assert abs(REF.params(d) / 1e9 - 15.96) < 0.01 and d["reduced"] == []
    for key, bad in (("q_lora_rank", 1536), ("scoring_func", "softmax"), ("n_group", 8)):
        with pytest.raises(ValueError, match=key):
            mla_moe.MLAMoEConfig.from_dict(dict(d, **{key: bad}), 0, 1)
    drv = registry.load_module(os.path.join(ROOT, "portbench", "drivers", "lm_backlog.py"), "lm_backlog_under_test")
    small = dict(ref_config("bfloat16"), ep_size=1, num_nextn_predict_layers=0)
    assert drv.build_model(small, SEED, torch.device("cpu")).dtype == torch.bfloat16
    for key, bad in (("ep_size", 2), ("num_nextn_predict_layers", 1)):
        with pytest.raises(ValueError, match=key):
            drv.build_model(dict(small, **{key: bad}), SEED, torch.device("cpu"))


def test_request_flops_count_the_forward():
    """The yardstick: FLOPs of a request grow with its prompt, a token's
    attention with its context; Moonlight's request of the cell's median
    shape is a few TFLOP."""
    d = ref_config("float32")
    one = REF.request_flops(d, 1, 1)
    assert one == sum(REF._token_flops(d, i, 1) for i in range(3)) + 2 * 64 * 256
    with open(FILE) as f:
        big = json.load(f)
    tf = REF.request_flops(big, 420 + 400, 256) / 1e12
    assert 4.0 < tf < 7.0, tf
    flops, byts = REF.expert_gemm_cost(big, 128)
    assert flops == 26 * 2 * 128 * 6 * 3 * 2048 * 1408 and 0.98 * 26 * 64 * 3 * 2048 * 1408 * 2 < byts


def test_generate_records_its_spans_and_expert_load():
    model, _ = build()
    _, ids, lengths = prompts([5, 8])
    profiling.take_spans()
    with profiling.record_spans():
        mla_moe.generate(model, ids, lengths, 4)
    spans = profiling.take_spans()
    (gen,) = [s for s in spans if s.name == "lm.generate"]
    (pre,) = [s for s in spans if s.name == "lm.prefill"]
    steps = [s for s in spans if s.name == "lm.step"]
    assert gen.attrs["requests"] == 2 and gen.attrs["prompt_tokens"] == 13 and gen.attrs["new_tokens"] == 4
    assert pre.attrs["tokens"] == 13 and pre.parent == gen.id
    assert [s.attrs["step"] for s in steps] == [0, 1, 2] and not any(s.attrs["graph"] for s in steps)
    assert gen.attrs["expert_load_max_over_mean"] >= 1.0
    # the counter: pairs an expert took, over the prefill and the steps
    state = mla_moe.LMState(model, 2, 12, 4, torch.device("cpu"))
    state.load(ids, lengths)
    for _ in range(3):
        state.step()
    assert state.load_count.shape == (2, 8) and int(state.load_count.sum()) == 2 * 2 * (13 + 2 * 3)


def test_eos_holds_once_emitted(monkeypatch):
    """EOS wins row 0's logits at the third position only: the row emits
    EOS from there on, the other row decodes on."""
    model, _ = build()
    _, ids, lengths = prompts([4, 6])
    want, _ = cached_steps(model, ids, lengths, 6)
    real, calls = mla_moe.head_logits, []

    def eos_once(m, x):
        out = real(m, x)
        calls.append(1)
        if len(calls) == 3:
            out[0, EOS] = 100.0
        return out

    monkeypatch.setattr(mla_moe, "head_logits", eos_once)
    got, _ = cached_steps(model, ids, lengths, 6)
    assert torch.equal(got[0, :2], want[0, :2]) and (got[0, 2:] == EOS).all()
    assert torch.equal(got[1], want[1])


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tokens", [1, 128, 3000])
def test_cuda_grouped_gemm_matches_the_expert_loop(cuda_device, dtype, tokens):
    """The CUDA grouped GEMM against the per-expert loop on the card, at
    Moonlight's widths (64 experts of 1408, hidden 2048, 6 a token): the
    decode block (few pairs an expert) and the prefill block. bfloat16:
    the same roundings, the products summed in another order (within one
    bfloat16 step of the output's scale); float32 within 1e-4."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    e, w, h, k = 64, 1408, 2048, 6
    x = torch.randn(tokens, h, generator=g, device=cuda_device).to(dtype)
    gate, up = (torch.randn(e, w, h, generator=g, device=cuda_device).mul(0.02).to(dtype) for _ in range(2))
    down = torch.randn(e, h, w, generator=g, device=cuda_device).mul(0.02).to(dtype)
    idx = torch.rand(tokens, e, generator=g, device=cuda_device).topk(k).indices
    weight = torch.rand(tokens, k, generator=g, device=cuda_device)
    before = moe_gemm.routed_experts.launches
    got = moe_gemm.routed_experts(x, idx, weight, gate, up, down)
    torch.cuda.synchronize()
    assert moe_gemm.routed_experts.launches == before + 1
    want = moe_gemm.routed_experts_plain(x, idx, weight, gate, up, down)
    diff = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    print(f"\n{dtype} {tokens} tokens: max diff {diff:.3g} of max {scale:.3g}")
    assert diff <= (1e-4 if dtype == torch.float32 else 2 ** -7 * scale)


def _card_model(dev, dtype=torch.bfloat16):
    return build(dtype, device=dev, hidden_size=256, num_attention_heads=8, num_key_value_heads=8, kv_lora_rank=128,
                 qk_nope_head_dim=32, qk_rope_head_dim=32, v_head_dim=32, moe_intermediate_size=128,
                 n_routed_experts=16, num_experts_per_tok=4, intermediate_size=512, vocab_size=1024)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_prefill_then_decode_follows_the_reference(cuda_device, dtype):
    """The small model on the card (the grouped GEMM, the fused attention,
    the graphed step) against the reference on the card: float32 within
    1e-4 (sums in another order), bfloat16 within 0.05 (as on the CPU)."""
    model, d = build(dtype, device=cuda_device)
    rows, ids, lengths = prompts([7, 12, 3, 9])
    tokens = mla_moe.generate(model, ids.to(cuda_device), lengths, 8)
    _, logits = cached_steps(model, ids.to(cuda_device), lengths.to(cuda_device), 8)
    seqs = [torch.from_numpy(np.concatenate([r, t[:-1]]).astype(np.int64)).to(cuda_device)
            for r, t in zip(rows, tokens.cpu().numpy())]
    at = [torch.arange(len(r) - 1, len(r) + 7, device=cuda_device) for r in rows]
    torch.backends.cuda.matmul.allow_tf32 = False
    want = torch.stack(REF.forward_logits(d, SEED, seqs, at, [lambda x: x], cuda_device)[0])
    gap = float((logits - want).abs().max())
    print(f"\n{dtype}: logits within {gap:.3g} of the reference")
    assert gap < (1e-4 if dtype == torch.float32 else 0.05), gap


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 16])
def test_cuda_graph_step_equals_the_eager_step(cuda_device, batch):
    """Replaying the captured step gives the eager step's ids and last
    logits bit for bit; the graph holds the step (the index moved on)."""
    model, _ = _card_model(cuda_device)
    _, ids, lengths = prompts([5 + 3 * i for i in range(batch)])
    ids, lengths = ids.to(cuda_device), lengths.to(cuda_device)
    got = mla_moe.generate(model, ids, lengths, 12, slots=96)
    (state,) = mla_moe._STATES[model].values()
    assert state.graph is not None and int(state.t) == 11
    tokens, logits = cached_steps(model, ids, lengths, 12, slots=96)
    assert torch.equal(got, tokens) and torch.equal(state.logits, logits[:, -1])
    again = mla_moe.generate(model, ids, lengths, 12, slots=96)
    assert torch.equal(again, got) and len(mla_moe._STATES[model]) == 1


@pytest.mark.gpu
def test_cuda_graph_step_on_a_second_card():
    """The model on ``cuda:1`` while ``cuda:0`` is current: the capture runs
    on the model's card, and the graph is not empty (the index moved on)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda", 1)
    with torch.cuda.device(0):
        model, _ = _card_model(dev)
        _, ids, lengths = prompts([6, 9])
        got = mla_moe.generate(model, ids.to(dev), lengths.to(dev), 8, slots=32)
        assert torch.cuda.current_device() == 0
        (state,) = mla_moe._STATES[model].values()
        assert int(state.t) == 7
        assert torch.equal(got, cached_steps(model, ids.to(dev), lengths.to(dev), 8, slots=32)[0])
