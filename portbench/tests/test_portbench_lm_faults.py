"""Runs of ``moonlight_books128`` with the model's math broken underneath:
``correct`` comes out false for each fault, and true without one.

Each run skips the look for a card and drives the rest on the CPU: the
cell's configuration cut to a small size in float32 (hidden 64, 4 heads, a
latent of 32, rope 16, 8 experts with 2 a token and 1 shared, 3 layers of
which the first is dense, 512 ids), the matrices drawn at 0.02 * sqrt(2048
/ 64) so that each layer's gain, and the logits' spread, are those of the
published widths; 8 prompts of 64 shared and 16 to 128 own tokens, 32
new tokens, a window of one call, every request judged, the cell's own
check with the cell's limits; the feed-forward output projections at that over sqrt(2 *
layers), the embeddings at N(0, 1), as the configuration draws them. "Top-k less one" is top-1 of 2 here, as top-5 of 6 is at full size.
"""

import copy
import time

import pytest
import torch

from portbench import control
from portbench.core import bench, registry

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16, intermediate_size=128,
             moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2)
SEED = 2**31 + 20261019


def small_cell():
    cell = registry.find_cell("moonlight_books128")
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config.update(SMALL, dtype="float32")
    cell.config["assumed"].update(bos_token_id=500, eos_token_id=501, ordinary_ids=500)
    init = cell.config["assumed"]["init"]
    init["std"] = 0.02 * (2048 / 64) ** 0.5
    init["out_std"] = init["std"] / (2 * SMALL["num_hidden_layers"]) ** 0.5
    cell.traffic.update(batch=8, prefix_tokens=64, context_median=64, context_min=16, context_max=128, new_tokens=32,
                        check_requests=7)
    return cell


def run_cell(seed=SEED):
    torch.set_num_threads(4)
    cell = small_cell()
    run = bench.Run(cell, seed, 0.001, False)  # one call a window
    run.state["t_process"] = time.perf_counter()
    return bench.execute(run, registry.driver(cell), require_cuda=False)


def _route(k_less=0, bias=True, norm=True, scale=True):
    import torch.nn.functional as F

    def route(cfg, x, w):
        scores = F.linear(x.float(), w["mlp.gate.weight"].float()).sigmoid()
        choice = scores + (w["mlp.gate.e_score_correction_bias"].float()[None] if bias else 0)
        idx = torch.topk(choice, cfg.num_experts_per_tok - k_less, dim=-1, sorted=False).indices
        weight = scores.gather(1, idx)
        if norm:
            weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
        return idx, weight * (cfg.routed_scaling_factor if scale else 1.0)

    return route


def install_fault(monkeypatch, kind):
    """Break the model's math in one way (``kind``) through ``monkeypatch``."""
    from bbocr_tpu_torch.kernels import moe_gemm
    from bbocr_tpu_torch.models import mla_moe

    if kind == "no_shared_expert":
        def ffn(cfg, x, w, load):
            if "mlp.gate_proj.weight" in w:
                return mla_moe.swiglu(x, w["mlp.gate_proj.weight"], w["mlp.up_proj.weight"], w["mlp.down_proj.weight"])
            idx, weight = mla_moe.route(cfg, x, w)
            return moe_gemm.routed_experts(x, idx, weight, w["mlp.experts.gate_proj"], w["mlp.experts.up_proj"],
                                           w["mlp.experts.down_proj"])

        monkeypatch.setattr(mla_moe, "ffn", ffn)
    elif kind == "no_rope_key":
        real = mla_moe._latent

        def latent(cfg, x, w, cos, sin):
            out = real(cfg, x, w, cos, sin).clone()
            out[..., cfg.kv_lora_rank:] = 0
            return out

        monkeypatch.setattr(mla_moe, "_latent", latent)
    else:
        monkeypatch.setattr(mla_moe, "route", _route(**{
            "top_k_less_one": dict(k_less=1), "no_bias_in_selection": dict(bias=False),
            "no_normalization": dict(norm=False), "no_scale": dict(scale=False)}[kind]))


FAULTS = ["no_shared_expert", "top_k_less_one", "no_bias_in_selection", "no_normalization", "no_scale", "no_rope_key"]


def test_lm_sound_run_is_correct():
    out = run_cell()
    assert out["correct"] and out["failed"] == 0, out["check"]


@pytest.mark.parametrize("kind", FAULTS)
def test_lm_fault_is_not_correct(monkeypatch, kind):
    install_fault(monkeypatch, kind)
    out = run_cell()
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("seed", [SEED + 1, SEED + 2, SEED + 3])
def test_lm_float8_control_reads_above_the_bfloat16_program(seed):
    """The reference in float8 in the program's place (``control.py
    --mode control``) against the program in bfloat16, the configuration's
    type, on the same requests: its mean gap is several times the
    program's. The limits hold only at full size, where they were set (on the
    card the control's mean gap is 4.8 times the program's widest): at this
    size the control's mean gap spreads from 0.0063 to 0.0154 over seeds,
    around the limit of 0.009, so this test compares the two readings and
    not a reading with the limit. 12 layers and one call of 16 requests
    a window, 15 of them judged over 128 tokens each."""
    torch.set_num_threads(4)
    cell = small_cell()
    cell.config["num_hidden_layers"] = 12
    init = cell.config["assumed"]["init"]
    init["out_std"] = init["std"] / (2 * 12) ** 0.5
    cell.traffic.update(batch=16, new_tokens=128, check_requests=15)
    (low,) = control.readings(cell, "control", [seed], 0.001, device="cpu")
    cell.config["dtype"] = "bfloat16"
    (prog,) = control.readings(cell, "program", [seed], 0.001, device="cpu")
    print(seed, low["check"], prog["check"])
    assert low["check"]["token_gap_mean"] > 2 * prog["check"]["token_gap_mean"], (low, prog)
