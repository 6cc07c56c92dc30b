"""CTC prefix beam search decoding on the host.

Copy of ``bbocr_tpu/decode/beam.py``: the standard prefix-merging beam over
per-frame log-probs, in Python and numpy. It is the oracle the on-device
beam (``decode/beam_device.py``) is tested against.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import List, Sequence, Tuple

import numpy as np

from bbocr_tpu_torch.models.charset import BLANK_ID

NEG_INF = -math.inf


def _logsumexp2(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def ctc_beam_decode(
    log_probs: np.ndarray,
    beam_width: int = 8,
    blank: int = BLANK_ID,
    top_k_per_frame: int = 16,
) -> Tuple[Tuple[int, ...], float]:
    """Decode one sequence.

    Args:
        log_probs: (T, C) float array of per-frame log-probabilities.
        beam_width: beams kept per frame.
        top_k_per_frame: candidate symbols expanded per frame (perf cap).

    Returns:
        (label tuple, log probability of the best prefix).
    """
    t_len, n_cls = log_probs.shape
    # beams: prefix -> (log_p ending in blank, log_p ending in non-blank)
    beams = {(): (0.0, NEG_INF)}
    for t in range(t_len):
        frame = log_probs[t]
        cand = np.argsort(frame)[::-1][:top_k_per_frame]
        next_beams: dict = defaultdict(lambda: (NEG_INF, NEG_INF))
        for prefix, (p_b, p_nb) in beams.items():
            p_total = _logsumexp2(p_b, p_nb)
            for c in cand:
                p_c = float(frame[c])
                if c == blank:
                    nb_b, nb_nb = next_beams[prefix]
                    next_beams[prefix] = (_logsumexp2(nb_b, p_total + p_c), nb_nb)
                    continue
                last = prefix[-1] if prefix else None
                if c == last:
                    # repeat: extends the non-blank path of the same prefix...
                    nb_b, nb_nb = next_beams[prefix]
                    next_beams[prefix] = (nb_b, _logsumexp2(nb_nb, p_nb + p_c))
                    # ...or starts a new symbol after a blank
                    ext = prefix + (int(c),)
                    eb_b, eb_nb = next_beams[ext]
                    next_beams[ext] = (eb_b, _logsumexp2(eb_nb, p_b + p_c))
                else:
                    ext = prefix + (int(c),)
                    eb_b, eb_nb = next_beams[ext]
                    next_beams[ext] = (eb_b, _logsumexp2(eb_nb, p_total + p_c))
        beams = dict(
            sorted(
                next_beams.items(),
                key=lambda kv: _logsumexp2(*kv[1]),
                reverse=True,
            )[:beam_width]
        )
    best_prefix, (p_b, p_nb) = max(beams.items(), key=lambda kv: _logsumexp2(*kv[1]))
    return best_prefix, _logsumexp2(p_b, p_nb)


def ctc_beam_decode_batch(
    logits: np.ndarray,
    lengths: Sequence[int] | None = None,
    beam_width: int = 8,
    blank: int = BLANK_ID,
) -> List[Tuple[Tuple[int, ...], float]]:
    """(B, T, C) raw logits -> per-row (labels, logp)."""
    logits = np.asarray(logits, np.float64)
    # log-softmax
    m = logits.max(axis=-1, keepdims=True)
    lse = m + np.log(np.exp(logits - m).sum(axis=-1, keepdims=True))
    log_probs = logits - lse
    out = []
    for i in range(log_probs.shape[0]):
        t_len = int(lengths[i]) if lengths is not None else log_probs.shape[1]
        out.append(ctc_beam_decode(log_probs[i, :t_len], beam_width, blank))
    return out
