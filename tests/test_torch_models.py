"""The port's models, weight bridge and decoding against the JAX package,
in float32 on the CPU, with the shipped checkpoints."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bbocr_tpu.decode.ctc import ctc_greedy_decode as jax_ctc
from bbocr_tpu.models.craft import CRAFT as JaxCRAFT
from bbocr_tpu.models.crnn import CRNN as JaxCRNN
from bbocr_tpu.models.weights import fold_gray_stem as jax_fold
from bbocr_tpu.utils.checkpoint import load_params as jax_load
from bbocr_tpu_torch.models import CRAFT, CRNN, craft_state_dict, crnn_state_dict, fold_gray_stem
from bbocr_tpu_torch.decode import ctc_greedy_decode
from bbocr_tpu_torch.utils.checkpoint import load_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRAFT_NPZ = os.path.join(ROOT, "checkpoints", "craft.npz")
CRNN_NPZ = os.path.join(ROOT, "checkpoints", "crnn.npz")


@pytest.fixture(scope="module")
def craft_params():
    return load_params(CRAFT_NPZ)


@pytest.fixture(scope="module")
def crnn_params():
    return load_params(CRNN_NPZ)


@pytest.mark.parametrize("folded", [False, True], ids=["rgb_stem", "gray_stem"])
def test_craft_checkpoint_loads_with_every_key(craft_params, folded):
    params = fold_gray_stem(craft_params) if folded else craft_params
    result = CRAFT(gray_input=folded).load_state_dict(craft_state_dict(params), strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_crnn_checkpoint_loads_with_every_key(crnn_params):
    result = CRNN(97).load_state_dict(crnn_state_dict(crnn_params), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    sd = crnn_state_dict(crnn_params)
    lstm = crnn_params["params"]["rnn0"]["bwd"]
    for leaf in ("w_ih", "w_hh", "b_ih"):  # LSTMScan keeps the JAX layout
        np.testing.assert_array_equal(sd[f"rnn0.bwd.{leaf}"].numpy(), np.asarray(lstm[leaf], np.float32))


def test_fold_gray_stem_matches_jax(craft_params):
    ours = fold_gray_stem(craft_params)["params"]["VGG16BN_0"]["ConvBN_0"]["Conv_0"]["kernel"]
    ref = jax_fold(jax_load(CRAFT_NPZ))["params"]["VGG16BN_0"]["ConvBN_0"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(ours, np.asarray(ref))


@pytest.mark.parametrize("size", [(64, 64), (96, 128)], ids=["64x64", "96x128"])
@pytest.mark.parametrize("folded", [False, True], ids=["rgb_stem", "gray_stem"])
def test_craft_maps_match_jax(craft_params, size, folded):
    """Region and affinity maps, abs <= 1e-4: float32 convolutions summed
    in other orders, and GroupNorm's variance computed another way, move
    the sigmoid scores by about 1e-6."""
    rng = np.random.default_rng(0)
    h, w = size
    if folded:
        x = rng.uniform(0, 255, (1, h, w, 1)).astype(np.float32)
        jparams = jax_fold(jax_load(CRAFT_NPZ))
    else:
        x = rng.normal(0, 1, (1, h, w, 3)).astype(np.float32)
        jparams = jax_load(CRAFT_NPZ)
    ref = np.asarray(JaxCRAFT(dtype=jnp.float32, gray_input=folded).apply(jparams, jnp.asarray(x)))
    model = CRAFT(gray_input=folded)
    model.load_state_dict(craft_state_dict(fold_gray_stem(craft_params) if folded else craft_params))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (1, h // 2, w // 2, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("size", [(2, 2), (3, 4), (6, 8)])
def test_upsample_is_jax_bilinear(size):
    """CRAFT's ``_upsample_to`` (jax.image.resize, bilinear) is
    F.interpolate(bilinear, align_corners=False) for 2x upsamples;
    abs <= 1e-5 for float32 interpolation weights."""
    x = np.random.default_rng(1).normal(0, 1, (1,) + size + (3,)).astype(np.float32)
    h, w = size
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 2 * h, 2 * w, 3), method="bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(2 * h, 2 * w), mode="bilinear", align_corners=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("width", [64, 128])
def test_crnn_logits_match_jax(crnn_params, width):
    """Logits abs <= 1e-3 (float32 LSTM recurrences accumulate rounding
    differently; observed about 1e-5) and equal greedy ids."""
    x = np.random.default_rng(2).uniform(-1, 1, (3, 32, width, 1)).astype(np.float32)
    ref = np.asarray(JaxCRNN(num_classes=97, dtype=jnp.float32).apply(jax_load(CRNN_NPZ), jnp.asarray(x)))
    model = CRNN(97)
    model.load_state_dict(crnn_state_dict(crnn_params))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == ref.shape == (3, width // 4 - 1, 97)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_ctc_greedy_decode_matches_jax():
    """ids and lengths equal; confidence rtol 1e-5 (float32 softmax)."""
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 3, (6, 31, 97)).astype(np.float32)
    logits[0] = -10.0  # all-blank row: nothing emitted, confidence 0
    logits[0, :, 0] = 10.0
    lengths = np.array([31, 31, 10, 1, 20, 31], np.int32)
    ref = [np.asarray(a) for a in jax_ctc(jnp.asarray(logits), jnp.asarray(lengths))]
    got = [a.numpy() for a in ctc_greedy_decode(torch.from_numpy(logits), torch.from_numpy(lengths))]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=0)
    assert got[2][0] == 0.0
