"""Character and word error rates.

Copy of ``bbocr_tpu/utils/cer.py`` (the port imports nothing of the JAX
package): the metrics of the evaluation CLIs (``cli/evaluate.py``).
"""

from __future__ import annotations

from typing import Sequence


def levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        curr = [i]
        for j, cb in enumerate(b, 1):
            curr.append(min(prev[j] + 1, curr[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = curr
    return prev[-1]


def cer(ref: str, hyp: str) -> float:
    """Character error rate: edit distance / reference length."""
    if not ref:
        return 0.0 if not hyp else 1.0
    return levenshtein(ref, hyp) / len(ref)


def corpus_cer(refs: Sequence[str], hyps: Sequence[str]) -> float:
    total_edits = sum(levenshtein(r, h) for r, h in zip(refs, hyps))
    total_chars = sum(len(r) for r in refs)
    return total_edits / max(total_chars, 1)


def wer(ref: str, hyp: str) -> float:
    """Word error rate over whitespace tokens."""
    r = ref.split()
    h = hyp.split()
    if not r:
        return 0.0 if not h else 1.0
    # token-level Levenshtein
    prev = list(range(len(h) + 1))
    for i, rt in enumerate(r, 1):
        curr = [i]
        for j, ht in enumerate(h, 1):
            curr.append(min(prev[j] + 1, curr[j - 1] + 1, prev[j - 1] + (rt != ht)))
        prev = curr
    return prev[-1] / len(r)
