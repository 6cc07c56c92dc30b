"""The port's ``LSTMScan`` against the JAX package's, on the CPU.

``bbocr_tpu_torch.models.crnn.bidirectional_scan`` rounds where flax's
bfloat16 ``LSTMScan`` rounds and sums its matrix products in the order of
XLA's CPU dot, so in bfloat16 the two agree bit for bit. The cases take
the shipped rnn0 and rnn1 weights, both directions, T = 15 and 127 (the
narrowest and widest recognizer buckets) and batches of 3 and 64 rows,
one on each side of the 50-row line where XLA's CPU dot changes its
summation order. One row is not covered: XLA runs a one-row product as a
matrix-vector product in another order, and the engine pads every
recognize batch to at least 8 rows.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbocr_tpu.models.crnn import LSTMScan as JaxLSTMScan
from bbocr_tpu.utils.checkpoint import load_params as jax_load
from bbocr_tpu_torch.models import CRNN, cast_for_compute, crnn_state_dict
from bbocr_tpu_torch.models.crnn import LSTMScan, bidirectional_scan
from bbocr_tpu_torch.utils.checkpoint import load_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRNN_NPZ = os.path.join(ROOT, "checkpoints", "crnn.npz")
HIDDEN = 256


@pytest.fixture(scope="module")
def rnn_params():
    return jax_load(CRNN_NPZ)["params"]


def _both(params, layer: str, x: np.ndarray, jdt, tdt):
    """(JAX's fwd and bwd LSTMScan concatenated, the port's bidirectional scan)."""
    p = params[layer]
    xj = jnp.asarray(x, jdt)
    ref = np.concatenate([
        np.asarray(JaxLSTMScan(HIDDEN, reverse=rev, dtype=jdt).apply({"params": p[d]}, xj).astype(jnp.float32))
        for d, rev in (("fwd", False), ("bwd", True))
    ], axis=-1)
    dirs = []
    for d in ("fwd", "bwd"):
        m = LSTMScan(x.shape[-1], HIDDEN)
        m.load_state_dict({k: torch.from_numpy(np.asarray(p[d][k], np.float32)) for k in ("w_ih", "w_hh", "b_ih")})
        dirs.append(m.to(tdt))
    with torch.no_grad():
        got = bidirectional_scan(torch.from_numpy(x).to(tdt), *dirs).float().numpy()
    return ref, got


@pytest.mark.parametrize("batch", [3, 64])
@pytest.mark.parametrize("steps", [15, 127])
@pytest.mark.parametrize("layer", ["rnn0", "rnn1"])
def test_lstm_scan_bf16_is_jax_bit_for_bit(rnn_params, layer, steps, batch):
    x = np.random.default_rng(steps + batch).normal(0, 1, (batch, steps, 256)).astype(np.float32)
    ref, got = _both(rnn_params, layer, x, jnp.bfloat16, torch.bfloat16)
    assert got.shape == (batch, steps, 2 * HIDDEN)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("steps", [15, 127])
@pytest.mark.parametrize("layer", ["rnn0", "rnn1"])
def test_lstm_scan_f32_matches_jax(rnn_params, layer, steps):
    """float32: abs <= 1e-5 (XLA computes exp, tanh and its sigmoid its own
    way; about 1e-6 is observed)."""
    x = np.random.default_rng(steps).normal(0, 1, (3, steps, 256)).astype(np.float32)
    ref, got = _both(rnn_params, layer, x, jnp.float32, torch.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_crnn_runs_no_torch_rnn(dtype):
    """The recognizer's LSTMs are the plain scan in either type: no
    ``nn.LSTM`` (or any ``nn.RNNBase``) module, and the scan's parameters
    take the compute type."""
    model = CRNN(97)
    model.load_state_dict(crnn_state_dict(load_params(CRNN_NPZ)), strict=True)
    cast_for_compute(model, dtype)
    assert not any(isinstance(m, torch.nn.RNNBase) for m in model.modules())
    scans = [m for m in model.modules() if isinstance(m, LSTMScan)]
    assert len(scans) == 4 and all(p.dtype == dtype for m in scans for p in m.parameters())
    with torch.no_grad():
        out = model.eval()(torch.zeros(2, 1, 32, 64, dtype=dtype))
    assert out.shape == (2, 15, 97) and out.dtype == torch.float32 and torch.isfinite(out).all()
