"""Greedy CTC decoding on the device.

Counterpart of ``bbocr_tpu/decode/ctc.py::ctc_greedy_decode``: argmax,
repeat-merge, blank-drop and a stable compaction, all tensor ops, so only
token ids, lengths and confidences go back to the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from bbocr_tpu_torch.models.charset import BLANK_ID


def ctc_greedy_decode(logits: torch.Tensor, lengths: Optional[torch.Tensor] = None, blank: int = BLANK_ID):
    """Greedy CTC decode of (B, T, C) logits.

    ``lengths``: optional (B,) valid frame counts; frames beyond are blank
    (width-bucket padding). Returns ``ids`` (B, T) int32 compacted to the
    front and zero padded, ``out_lengths`` (B,) int32, and ``confidence``
    (B,) float32, the product of the per-frame max softmax probabilities
    over the emitted frames (0 when nothing is emitted).
    """
    b, t, _ = logits.shape
    best = torch.argmax(logits, dim=-1).to(torch.int32)
    if lengths is not None:
        frame = torch.arange(t, device=logits.device)[None, :]
        best = torch.where(frame < lengths[:, None], best, torch.full_like(best, blank))
    prev = torch.cat([torch.full((b, 1), -1, dtype=torch.int32, device=logits.device), best[:, :-1]], dim=1)
    keep = (best != blank) & (best != prev)

    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    ids = torch.gather(torch.where(keep, best, torch.zeros_like(best)), 1, order)
    out_lengths = keep.sum(dim=1).to(torch.int32)

    pmax = torch.softmax(logits.float(), dim=-1).amax(dim=-1)
    logp = torch.where(keep, torch.log(torch.clamp(pmax, min=1e-9)), torch.zeros_like(pmax))
    conf = torch.exp(logp.sum(dim=1))
    conf = torch.where(out_lengths > 0, conf, torch.zeros_like(conf))
    return ids, out_lengths, conf
