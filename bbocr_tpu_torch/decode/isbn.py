"""Digit-biased ISBN decoding on the host.

Copy of ``bbocr_tpu/decode/isbn.py``. ISBN crops are digit strings where
the recognizer's letter prior hurts ('1'/'I', '0'/'O', '5'/'S' confusions
flip checksum digits), so ISBN-suspect crops are re-decoded:

1. bias the per-frame log-probs toward the ISBN alphabet (digits, '-', 'X',
   space, the literal letters of "ISBN") by a constant log-prior;
2. prefix beam search over biased and unbiased probs, keeping the N-best;
3. extract digit runs from every beam and keep the first candidate that
   passes the ISBN-10 / ISBN-13 checksum (``extract.heuristics``).
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from bbocr_tpu_torch.extract.heuristics import isbn10_valid, isbn13_valid
from bbocr_tpu_torch.models.charset import BLANK_ID, EN_CHARSET, Charset

# Text that warrants a digit-biased re-read: mentions ISBN or carries a
# long-ish digit run (possibly broken by OCR confusions).
ISBN_SUSPECT_RE = re.compile(r"(?i)isbn|[\dOIlSB|]{8,}")


def is_isbn_suspect(text: str) -> bool:
    return bool(ISBN_SUSPECT_RE.search(text or ""))


def isbn_class_bias(
    charset: Charset = EN_CHARSET, bias: float = 1.2
) -> np.ndarray:
    """(C,) additive log-prior: +bias on the ISBN alphabet, 0 elsewhere."""
    favored = set("0123456789-X xISBN:")
    out = np.zeros(charset.num_classes, np.float64)
    for i, ch in enumerate(charset.chars):
        if ch in favored:
            out[i + 1] = bias
    return out


_CONFUSIONS = str.maketrans({"O": "0", "o": "0", "I": "1", "l": "1",
                             "|": "1", "S": "5", "s": "5", "B": "8",
                             "Z": "2", "z": "2", "g": "9", "q": "9"})


def _digit_candidates(text: str) -> List[str]:
    """Candidate ISBN strings from decoded text (raw + de-confused).

    Slides 13- and 10-wide windows over each full digit run (like
    ``heuristics.find_isbns``): a fused "ISBN" label misread as digits
    yields runs up to ~17 chars where the valid ISBN sits at an interior
    offset that fixed-length regex matching never produces.
    """
    cands = []
    for variant in (text, text.translate(_CONFUSIONS)):
        cleaned = re.sub(r"[^\dX]", "", variant.upper().replace("ISBN", ""))
        for ln in (13, 10):
            for start in range(0, len(cleaned) - ln + 1):
                cands.append(cleaned[start : start + ln])
    return cands


def validate_isbn(candidates: Sequence[str]) -> Optional[str]:
    for c in candidates:
        if len(c) == 13 and isbn13_valid(c):
            return c
        if len(c) == 10 and isbn10_valid(c):
            return c
    return None


def _nbest_beams(
    log_probs: np.ndarray, beam_width: int, blank: int
) -> List[Tuple[Tuple[int, ...], float]]:
    """Prefix beam search returning the final beam list (N-best)."""
    from bbocr_tpu_torch.decode.beam import _logsumexp2
    from collections import defaultdict

    beams = {(): (0.0, -math.inf)}
    t_len = log_probs.shape[0]
    for t in range(t_len):
        frame = log_probs[t]
        cand = np.argsort(frame)[::-1][:16]
        nxt: dict = defaultdict(lambda: (-math.inf, -math.inf))
        for prefix, (p_b, p_nb) in beams.items():
            p_total = _logsumexp2(p_b, p_nb)
            for c in cand:
                p_c = float(frame[c])
                if c == blank:
                    b, nb = nxt[prefix]
                    nxt[prefix] = (_logsumexp2(b, p_total + p_c), nb)
                    continue
                last = prefix[-1] if prefix else None
                if c == last:
                    b, nb = nxt[prefix]
                    nxt[prefix] = (b, _logsumexp2(nb, p_nb + p_c))
                    ext = prefix + (int(c),)
                    b2, nb2 = nxt[ext]
                    nxt[ext] = (b2, _logsumexp2(nb2, p_b + p_c))
                else:
                    ext = prefix + (int(c),)
                    b2, nb2 = nxt[ext]
                    nxt[ext] = (b2, _logsumexp2(nb2, p_total + p_c))
        beams = dict(
            sorted(nxt.items(), key=lambda kv: _logsumexp2(*kv[1]), reverse=True)[:beam_width]
        )
    return sorted(
        ((p, _logsumexp2(*v)) for p, v in beams.items()),
        key=lambda kv: kv[1],
        reverse=True,
    )


def decode_isbn(
    logits: np.ndarray,
    charset: Charset = EN_CHARSET,
    *,
    beam_width: int = 12,
    bias: float = 1.2,
    blank: int = BLANK_ID,
    max_margin: float = 3.0,
) -> Optional[str]:
    """(T, C) raw logits -> checksum-valid ISBN string, or None.

    Tries digit-biased beams first (stronger prior), then unbiased beams;
    every beam within ``max_margin`` nats of the best contributes its
    digit-run candidates, first checksum-valid one wins. The margin gate
    stops weak beams from hallucinating a "valid" ISBN via spurious digit
    insertions — only near-ties (the 1/I, 0/O, 5/S confusions this decoder
    exists for) may override the best path. Returns digits-only ISBN-10 or
    ISBN-13.
    """
    logits = np.asarray(logits, np.float64)
    m = logits.max(axis=-1, keepdims=True)
    log_probs = logits - (m + np.log(np.exp(logits - m).sum(axis=-1, keepdims=True)))

    for b in (bias, 0.0):
        biased = log_probs + isbn_class_bias(charset, b)[None, :] if b else log_probs
        beams = _nbest_beams(biased, beam_width, blank)
        if not beams:
            continue
        best_lp = beams[0][1]
        for prefix, lp in beams:
            if best_lp - lp > max_margin:
                break
            text = charset.decode_ids(prefix)
            got = validate_isbn(_digit_candidates(text))
            if got:
                return got
    return None
