"""The port's CTC prefix beams against the JAX package's, on the CPU.

``bbocr_tpu_torch.decode.beam_device`` (the device beam, a step loop over
frames batched over crops) against ``bbocr_tpu.decode.beam_device``
(``lax.scan``, vmapped) and the host oracle; the port's copies of the host
beam and of the digit-biased ISBN decode against the JAX package's. Seeded
logits, with ties, padded frames and prefixes that fill the buffer. Ids
must be equal, scores within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbocr_tpu.decode import isbn as jax_isbn
from bbocr_tpu.decode.beam import ctc_beam_decode as jax_host_beam
from bbocr_tpu.decode.beam import ctc_beam_decode_batch as jax_host_beam_batch
from bbocr_tpu.decode.beam_device import ctc_beam_decode_device as jax_beam
from bbocr_tpu_torch.decode import isbn
from bbocr_tpu_torch.decode.beam import ctc_beam_decode, ctc_beam_decode_batch
from bbocr_tpu_torch.decode.beam_device import ctc_beam_decode_device
from bbocr_tpu_torch.models.charset import EN_CHARSET

torch.set_num_threads(2)


def _logits(seed, shape, scale=2.0, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, scale, shape).astype(np.float32)
    if ties:
        # whole-number logits: equal values within a frame and equal sums
        # across candidates, so top-k and the beam choice meet ties
        x = np.round(x).astype(np.float32)
    return x


def _both(logits, lengths=None, **kw):
    ref = jax_beam(jnp.asarray(logits), None if lengths is None else jnp.asarray(lengths), **kw)
    got = ctc_beam_decode_device(torch.from_numpy(logits), None if lengths is None else torch.from_numpy(lengths), **kw)
    return [np.asarray(a) for a in ref], [a.numpy() for a in got]


CASES = {
    # name: (seed, (B, T, C), lengths, kwargs, ties)
    "small_space": (4, (6, 6, 5), None, dict(beam_width=4, top_k=5, max_len=8), False),
    "recognizer_width": (1, (4, 31, 97), None, dict(), False),
    "ties": (2, (6, 24, 12), None, dict(beam_width=6, top_k=8, max_len=16), True),
    "padded_frames": (3, (3, 40, 97), np.array([40, 17, 1], np.int32), dict(max_len=48), False),
    "full_prefix": (5, (3, 30, 20), None, dict(beam_width=4, top_k=6, max_len=4), False),
    "peaky_long": (6, (2, 95, 97), np.array([95, 60], np.int32), dict(max_len=48), False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_beam_matches_jax(name):
    seed, shape, lengths, kw, ties = CASES[name]
    logits = _logits(seed, shape, scale=6.0 if name == "peaky_long" else 2.0, ties=ties)
    (r_ids, r_lens, r_score), (g_ids, g_lens, g_score) = _both(logits, lengths, **kw)
    assert g_ids.dtype == np.int32 and g_lens.dtype == np.int32 and g_score.dtype == np.float32
    np.testing.assert_array_equal(g_lens, r_lens)
    np.testing.assert_array_equal(g_ids, r_ids)
    np.testing.assert_allclose(g_score, r_score, rtol=0, atol=1e-4)
    if name == "full_prefix":
        assert (g_lens == kw["max_len"]).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_beam_matches_host_oracle(seed):
    """With every symbol expanded, the device beam is the host beam: the
    same labels, scores within 1e-4 (float32 against float64)."""
    logits = _logits(seed, (5, 8, 6))
    ids, lens, score = ctc_beam_decode_device(torch.from_numpy(logits), beam_width=4, top_k=6, max_len=10)
    lp = torch.log_softmax(torch.from_numpy(logits), -1).double().numpy()
    for i in range(logits.shape[0]):
        lab, lp_best = jax_host_beam(lp[i], beam_width=4, top_k_per_frame=6)
        assert tuple(ids[i, : lens[i]].tolist()) == lab
        assert abs(lp_best - float(score[i])) < 1e-4


def test_host_beam_copy_matches_jax():
    logits = _logits(9, (4, 30, 97))
    lengths = [30, 22, 9, 1]
    assert ctc_beam_decode_batch(logits, lengths) == jax_host_beam_batch(logits, lengths)
    lp = torch.log_softmax(torch.from_numpy(logits[0]), -1).double().numpy()
    assert ctc_beam_decode(lp, beam_width=5, top_k_per_frame=7) == jax_host_beam(lp, beam_width=5, top_k_per_frame=7)


def _digit_logits(text, seed, confuse=()):
    """Per-frame logits spelling ``text`` with blanks between characters;
    at the frames of ``confuse`` (index, char) a look-alike letter wins by a
    small margin."""
    rng = np.random.default_rng(seed)
    frames = []
    for i, ch in enumerate(text):
        row = rng.normal(0, 0.5, 97).astype(np.float32)
        row[EN_CHARSET.encode(ch)[0]] = 6.0
        for j, alt in confuse:
            if j == i:
                row[EN_CHARSET.encode(alt)[0]] = 6.3
        frames.append(row)
        blank = rng.normal(0, 0.5, 97).astype(np.float32)
        blank[0] = 6.0
        frames.append(blank)
    return np.stack(frames)


@pytest.mark.parametrize(
    "text,confuse",
    [("ISBN 9780316769488", ()), ("ISBN 9780316769488", ((7, "O"), (12, "I"))), ("0-8118-2474-5", ((5, "S"),)),
     ("no digits here", ())],
    ids=["clean", "confused13", "confused10", "none"],
)
def test_isbn_decode_matches_jax(text, confuse):
    logits = _digit_logits(text, 3, confuse)
    assert isbn.decode_isbn(logits) == jax_isbn.decode_isbn(logits)
    for t in (text, "IS8N 978-O-316", "lllllllll", ""):
        assert isbn.is_isbn_suspect(t) == jax_isbn.is_isbn_suspect(t)
    assert isbn._digit_candidates(text) == jax_isbn._digit_candidates(text)
    np.testing.assert_array_equal(isbn.isbn_class_bias(), jax_isbn.isbn_class_bias())
