"""The port's bfloat16 forwards against the JAX package's, on the CPU.

flax defines where a ``dtype=jnp.bfloat16`` layer rounds: ``nn.Conv`` and
``nn.Dense`` round the product and then add the bias, ``nn.GroupNorm``
keeps float32 parameters and rounds once. The port's layers
(``bbocr_tpu_torch.models.layers``) round at the same points. The JAX side
runs op by op (``apply`` outside ``jit``), which is flax's definition:
under ``jit`` XLA on the CPU may skip a rounding inside a fusion (it
normalises the unrounded float32 conv output in ``ConvBN``), and no eager
PyTorch program can follow that.

What stays different: the float32 sums inside a conv run in another order,
which flips a bfloat16 rounding on about 1e-4 of the first layer's values;
those one-ulp differences grow layer by layer. The LSTM is the one layer
that rounds elsewhere: XLA runs ``LSTMScan``'s step with every op rounded
to bfloat16 and its sigmoid expanded as 1 / (1 + exp(-x)), each op rounded
too, where ``nn.LSTM`` keeps more precision. ``_xla_lstm_scan`` writes
that step out, and equals ``LSTMScan`` bit for bit.

Run as a script to print the layer-by-layer differences:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bf16.py
"""

import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbocr_tpu.models.craft import CRAFT as JaxCRAFT
from bbocr_tpu.models.craft import ConvBN as JaxConvBN
from bbocr_tpu.models.crnn import CRNN as JaxCRNN
from bbocr_tpu.models.crnn import LSTMScan
from bbocr_tpu.models.weights import fold_gray_stem as jax_fold
from bbocr_tpu.utils.checkpoint import load_params as jax_load
from bbocr_tpu_torch.models import CRAFT, CRNN, cast_for_compute, craft_state_dict, crnn_state_dict, fold_gray_stem
from bbocr_tpu_torch.models import layers
from bbocr_tpu_torch.models.craft import ConvBN
from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
from bbocr_tpu_torch.utils.checkpoint import load_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRAFT_NPZ = os.path.join(ROOT, "checkpoints", "craft.npz")
CRNN_NPZ = os.path.join(ROOT, "checkpoints", "crnn.npz")
BF16 = torch.bfloat16


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _diff(ref: np.ndarray, got: np.ndarray):
    """(max abs difference, share of values that differ)."""
    d = np.abs(ref - got)
    return float(d.max()), float((d > 0).mean())


def _hooks(named_modules):
    seen = {}

    def keep(name):
        def hook(module, inputs, output):
            seen[name] = output[0] if isinstance(output, tuple) else output
        return hook

    for name, module in named_modules:
        module.register_forward_hook(keep(name))
    return seen


def craft_layers(h: int, w: int, seed: int = 0):
    """Both packages' bfloat16 CRAFT (folded gray stem) on one seeded gray
    image. Returns (maps JAX, maps port, [(layer, max diff, share)]) in
    forward order: VGG convs 0-14, the four decoder DoubleConvs, the four
    head convs."""
    x = np.random.default_rng(seed).uniform(0, 255, (1, h, w, 1)).astype(np.float32)
    ref, state = JaxCRAFT(dtype=jnp.bfloat16, gray_input=True).apply(
        jax_fold(jax_load(CRAFT_NPZ)), jnp.asarray(x), capture_intermediates=True)
    inter = state["intermediates"]
    model = CRAFT(gray_input=True)
    model.load_state_dict(craft_state_dict(fold_gray_stem(load_params(CRAFT_NPZ))))
    cast_for_compute(model, BF16).eval()
    names = [(f"vgg{i}", ("VGG16BN_0", f"ConvBN_{i}"), m) for i, m in enumerate(model.backbone.convs)]
    names += [(f"decoder{i}", (f"DoubleConv_{i}",), m) for i, m in enumerate(model.decoder)]
    names += [(f"head{i}", (f"ConvBN_{i}",), m) for i, m in enumerate(model.head)]
    seen = _hooks((n, m) for n, _, m in names)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16))
    rows = []
    for name, path, _ in names:
        node = inter
        for p in path:
            node = node[p]
        rows.append((name, *_diff(_np(node["__call__"][0]), _nhwc(seen[name]))))
    return _np(ref), _nhwc(got), rows


def crnn_layers(width: int, seed: int = 2):
    """Both packages' bfloat16 CRNN on three seeded crops. Returns (logits
    JAX, logits port, [(layer, max diff, share)]): the conv trunk, each
    BiLSTM's LSTM pair and projection, the logits."""
    x = np.random.default_rng(seed).uniform(-1, 1, (3, 32, width, 1)).astype(np.float32)
    ref, state = JaxCRNN(num_classes=97, dtype=jnp.bfloat16).apply(
        jax_load(CRNN_NPZ), jnp.asarray(x, jnp.bfloat16), capture_intermediates=True)
    inter = state["intermediates"]
    model = CRNN(97)
    model.load_state_dict(crnn_state_dict(load_params(CRNN_NPZ)))
    cast_for_compute(model, BF16).eval()
    seen = _hooks([("features", model.features), ("rnn0.lstm", model.rnn0.lstm), ("rnn0", model.rnn0),
                   ("rnn1.lstm", model.rnn1.lstm), ("rnn1", model.rnn1)])
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16)).numpy()
    rows = [("features", *_diff(_np(inter["VGGFeatures_0"]["__call__"][0]), seen["features"].float().numpy()))]
    for r in ("rnn0", "rnn1"):
        pair = jnp.concatenate([inter[r]["fwd"]["__call__"][0], inter[r]["bwd"]["__call__"][0]], -1)
        rows.append((f"{r}.lstm", *_diff(_np(pair), seen[f"{r}.lstm"].float().numpy())))
        rows.append((r, *_diff(_np(inter[r]["__call__"][0]), seen[r].float().numpy())))
    ref = _np(ref)
    rows.append(("logits", *_diff(ref, got)))
    return ref, got, rows


# --- the layers, one at a time ---------------------------------------------

def _assert_one_ulp_on_few(got: np.ndarray, ref: np.ndarray) -> None:
    d = np.abs(got - ref)
    assert (d > 0).mean() <= 1e-3
    assert d.max() <= np.abs(ref).max() * 2.0**-7

def _conv_case(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (1, 24, 24, 64)).astype(np.float32)
    k = (rng.normal(0, 1, (3, 3, 64, 64)) / 24).astype(np.float32)
    return x, k, rng.normal(0, 0.3, 64).astype(np.float32), rng.normal(1, 0.2, 64).astype(np.float32)


def test_biased_conv_rounds_like_flax():
    """``nn.Conv(dtype=bf16)`` rounds the product, then adds the bias.
    The two float32 accumulations differ only in order, so at most 0.1 % of
    the values may differ, each by at most one bfloat16 ulp at the output's
    largest magnitude (2**-7 of it); ``nn.Conv2d``'s single rounding
    differs on about 30 %."""
    x, k, b, _ = _conv_case(0)
    ref = _np(fnn.Conv(64, (3, 3), padding="SAME", dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}}, jnp.asarray(x, jnp.bfloat16)))
    conv = layers.Conv2d(64, 64, 3, padding=1)
    conv.load_state_dict({"weight": torch.from_numpy(k.transpose(3, 2, 0, 1)), "bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = _nhwc(cast_for_compute(conv, BF16)(torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16)))
    _assert_one_ulp_on_few(got, ref)


def test_dense_rounds_like_flax():
    """``nn.Dense(dtype=bf16)`` against ``layers.Linear``: as for the conv."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (3, 31, 512)).astype(np.float32)
    k = (rng.normal(0, 1, (512, 256)) / 22).astype(np.float32)
    b = rng.normal(0, 0.3, 256).astype(np.float32)
    ref = _np(fnn.Dense(256, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}}, jnp.asarray(x, jnp.bfloat16)))
    lin = layers.Linear(512, 256)
    lin.load_state_dict({"weight": torch.from_numpy(k.T.copy()), "bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = cast_for_compute(lin, BF16)(torch.from_numpy(x).to(BF16)).float().numpy()
    _assert_one_ulp_on_few(got, ref)


def test_convbn_block_rounds_like_flax():
    """CRAFT's ``ConvBN`` (conv, GroupNorm with float32 parameters, ReLU):
    at most 0.1 % of the values differ, by one bfloat16 ulp at most."""
    x, k, b, s = _conv_case(2)
    ref = _np(JaxConvBN(64, dtype=jnp.bfloat16).apply(
        {"params": {"Conv_0": {"kernel": jnp.asarray(k)},
                    "GroupNorm_0": {"scale": jnp.asarray(s), "bias": jnp.asarray(b)}}},
        jnp.asarray(x, jnp.bfloat16)))
    block = ConvBN(64, 64)
    block.load_state_dict({"conv.weight": torch.from_numpy(k.transpose(3, 2, 0, 1)),
                           "norm.weight": torch.from_numpy(s), "norm.bias": torch.from_numpy(b)})
    cast_for_compute(block, BF16)
    assert block.norm.weight.dtype == torch.float32 and block.conv.weight.dtype == BF16
    with torch.no_grad():
        got = _nhwc(block(torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16)))
    _assert_one_ulp_on_few(got, ref)


def test_layers_in_float32_are_torch_layers():
    """In float32 the port's layers compute what ``torch.nn`` does, bit for bit."""
    x, _, _, _ = _conv_case(3)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    conv = layers.Conv2d(64, 64, 3, padding=1)
    norm = layers.GroupNorm(32, 64)
    lin = layers.Linear(64, 16)
    base_conv = torch.nn.Conv2d(64, 64, 3, padding=1)
    base_conv.load_state_dict(conv.state_dict())
    base_lin = torch.nn.Linear(64, 16)
    base_lin.load_state_dict(lin.state_dict())
    with torch.no_grad():
        assert torch.equal(conv(tx), base_conv(tx))
        ref_norm = torch.nn.functional.group_norm(tx, 32, norm.weight, norm.bias, layers.GROUPNORM_EPS)
        assert torch.equal(norm(tx), ref_norm)
        assert torch.equal(lin(tx.permute(0, 2, 3, 1)), base_lin(tx.permute(0, 2, 3, 1)))


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["float32", "bfloat16"])
def test_engine_keeps_groupnorm_parameters_in_float32(dtype):
    """The engine casts every parameter to the compute type but GroupNorm's,
    which stay float32 as flax's ``param_dtype``."""
    engine = OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, EngineConfig(compute_dtype=dtype), device="cpu")
    for model in (engine.craft, engine.crnn):
        for module in model.modules():
            for p in module.parameters(recurse=False):
                assert p.dtype == (torch.float32 if isinstance(module, torch.nn.GroupNorm) else dtype)


# --- the models ------------------------------------------------------------

@pytest.mark.parametrize("size", [(64, 64), (96, 128)], ids=["64x64", "96x128"])
def test_craft_maps_bf16_match_jax(size):
    """Sigmoid maps abs <= 0.01 (they reach 0.08 here; the aligned port
    differs by at most 0.003, from one-ulp conv sums grown over 27 layers),
    and the first layer agrees on all but 0.1 % of its values."""
    ref, got, rows = craft_layers(*size)
    assert got.shape == ref.shape == (1, size[0] // 2, size[1] // 2, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2)
    name, _, share = rows[0]
    assert name == "vgg0" and share <= 1e-3


@pytest.mark.parametrize("width", [64, 128])
def test_crnn_logits_bf16_match_jax(width):
    """Logits abs <= 0.25 (they reach about 14; the aligned port differs by
    at most 0.125, one ulp at that size, most of it from the LSTM, see
    ``_xla_lstm_scan``) and equal greedy ids."""
    ref, got, rows = crnn_layers(width)
    assert got.shape == ref.shape == (3, width // 4 - 1, 97)
    np.testing.assert_allclose(got, ref, rtol=0, atol=0.25)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


# --- the LSTM: where the two packages part ---------------------------------

def _xla_lstm_scan(x: torch.Tensor, w_ih, w_hh, b_ih) -> torch.Tensor:
    """``LSTMScan`` as XLA runs it on the CPU in bfloat16: every op rounded
    to bfloat16, sigmoid(v) as 1 / (1 + exp(-v)) with each op rounded."""
    def bf(v):
        return v.to(BF16).float()

    def sigmoid(v):
        return bf(1.0 / bf(1.0 + bf(torch.exp(-v))))

    xz = (x.to(BF16) @ w_ih.to(BF16) + b_ih.to(BF16)).float()
    h = torch.zeros(x.shape[0], w_hh.shape[0])
    c = torch.zeros_like(h)
    ys = []
    for t in range(x.shape[1]):
        z = bf(xz[:, t] + bf(h.to(BF16) @ w_hh.to(BF16)))
        i, f, g, o = z.chunk(4, dim=-1)
        i, f, g, o = sigmoid(i), sigmoid(f), bf(torch.tanh(g)), sigmoid(o)
        c = bf(bf(f * c) + bf(i * g))
        h = bf(o * bf(torch.tanh(c)))
        ys.append(h)
    return torch.stack(ys, dim=1)


def test_xla_lstm_scan_is_lstmscan():
    """The step above equals the JAX package's bfloat16 ``LSTMScan`` bit for
    bit, with the shipped rnn0 weights: it is what a port of the LSTM has
    to compute to agree exactly (ROADMAP Queue 3)."""
    p = jax_load(CRNN_NPZ)["params"]["rnn0"]["fwd"]
    x = np.random.default_rng(4).normal(0, 1, (2, 15, 256)).astype(np.float32)
    ref = _np(LSTMScan(256, dtype=jnp.bfloat16).apply({"params": p}, jnp.asarray(x, jnp.bfloat16)))
    got = _xla_lstm_scan(torch.from_numpy(x), *(torch.from_numpy(np.asarray(p[k])) for k in ("w_ih", "w_hh", "b_ih")))
    np.testing.assert_array_equal(got.numpy(), ref)


def _print_table(title, rows):
    print(title)
    for name, worst, share in rows:
        print(f"  {name:10s} max abs diff {worst:.6g}  values differing {share:.4%}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for h, w in ((64, 64), (96, 128)):
        ref, got, rows = craft_layers(h, w)
        _print_table(f"CRAFT bfloat16 {h}x{w}, maps max abs diff {np.abs(ref - got).max():.6g}", rows)
    for width in (64, 128):
        ref, got, rows = crnn_layers(width)
        _print_table(f"CRNN bfloat16 width {width}", rows)
    sys.exit(0)
