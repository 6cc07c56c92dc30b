"""CTC prefix beam search on the device, batched over crops.

Counterpart of ``bbocr_tpu/decode/beam_device.py::ctc_beam_decode_device``:
one step loop over frames, beams and frame candidates expanded as
fixed-shape tensors, and equal prefixes merged by sorting a rolling hash.
Only ids, lengths and scores go back to the host. The host beam
(``decode/beam.py``) is the oracle in the tests.

Where the JAX program's semantics need care in PyTorch:

- the rolling hash is ``uint32`` arithmetic that wraps; here it is
  ``int64`` masked to 32 bits, which orders as the unsigned value does;
- ``jax.lax.top_k`` breaks ties toward the lower index and ``jnp.argsort``
  is stable: both are a stable sort here (``torch.topk`` promises no order
  among equal values on CUDA);
- segment sums: the JAX program sums each merged prefix's candidates with
  ``segment_sum``. Here each candidate's segment is reduced over a
  (candidates x candidates) mask with a plain reduction, with no atomics,
  so the card and the CPU sum in a fixed order. A segment holds at most
  two candidates with nonzero mass (a prefix is one live beam's stay and
  at most one live beam's extension: ``p + c`` determines ``p`` and
  ``c``), and the others add exact zeros, so every order gives the sum
  the JAX program takes; only a 32-bit hash collision could break that,
  as it breaks the merge in the JAX program.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bbocr_tpu_torch.models.charset import BLANK_ID

NEG = float(np.float32(-1e30))
_HASH_MULT = 1000003
_MASK32 = 0xFFFFFFFF


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m))
    return torch.where(m <= NEG / 2, torch.full_like(out, NEG), out)


def _segment_logaddexp(vals: torch.Tensor, same: torch.Tensor) -> torch.Tensor:
    """(B, m) values, (B, m, m) same-segment mask -> each candidate's
    segment log-sum-exp (``NEG`` for a dead segment)."""
    peer = vals[:, None, :]
    m = torch.where(same, peer, torch.full_like(peer, -torch.inf)).amax(dim=-1)
    dead = m <= NEG / 2
    m_safe = torch.where(dead, torch.zeros_like(m), m)
    e = torch.exp(peer - m_safe[:, :, None])
    s = torch.where(same, e, torch.zeros_like(e)).sum(dim=-1)
    out = m_safe + torch.log(torch.clamp(s, min=1e-30))
    return torch.where(dead, torch.full_like(out, NEG), out)


def _top(x: torch.Tensor, k: int):
    """Top ``k`` along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def ctc_beam_decode_device(
    logits: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    beam_width: int = 8,
    top_k: int = 8,
    blank: int = BLANK_ID,
    max_len: int = 32,
):
    """Batched CTC prefix beam decode on the logits' device.

    Args:
        logits: (B, T, C) float logits.
        lengths: optional (B,) valid frame counts (width-bucket padding);
            frames beyond become certain blanks.
        beam_width, top_k: beams kept / symbols expanded per frame.
        max_len: prefix buffer length.

    Returns:
        ids (B, max_len) int32 zero padded, out_lengths (B,) int32, and
        score (B,) float32, the log probability of the best prefix.
    """
    dev = logits.device
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    b, t_len, n_cls = logp.shape
    k = min(top_k, n_cls - 1)
    w = beam_width
    m = w * (k + 2)

    frames = torch.full((b,), t_len, device=dev) if lengths is None else lengths.to(dev)
    blank_row = torch.full((n_cls,), NEG, dtype=torch.float32, device=dev)
    blank_row[blank] = 0.0
    valid = torch.arange(t_len, device=dev)[None, :] < frames.to(torch.int64)[:, None]
    logp = torch.where(valid[:, :, None], logp, blank_row)

    ids = torch.zeros((b, w, max_len), dtype=torch.int64, device=dev)
    lens = torch.zeros((b, w), dtype=torch.int64, device=dev)
    hsh = torch.zeros((b, w), dtype=torch.int64, device=dev)
    last = torch.full((b, w), -1, dtype=torch.int64, device=dev)
    p_b = torch.full((b, w), NEG, dtype=torch.float32, device=dev)
    p_b[:, 0] = 0.0
    p_nb = torch.full((b, w), NEG, dtype=torch.float32, device=dev)

    beams = torch.arange(w, device=dev)
    c_parent = torch.cat([beams, beams.repeat_interleave(k + 1)])
    stay_char = torch.full((b, w), -1, dtype=torch.int64, device=dev)
    no_mass = torch.full((b, w * (k + 1)), NEG, dtype=torch.float32, device=dev)
    dead_hash = _MASK32 - beams
    pos = torch.arange(max_len, device=dev)

    for t in range(t_len):
        logp_t = logp[:, t]
        p_tot = _logaddexp(p_b, p_nb)

        vals, chars = _top(logp_t, k + 1)  # may include blank
        ext_vals = torch.where(chars == blank, torch.full_like(vals, NEG), vals)
        p_blank = logp_t[:, blank]
        p_last = torch.where(
            last >= 0, torch.gather(logp_t, 1, last.clamp(min=0)), torch.full_like(p_b, NEG))

        # candidates: a stay per beam (blank, or a collapsed repeat), and
        # w x (k+1) extensions; a repeated char extends the blank-ended mass
        stay_pb = p_tot + p_blank[:, None]
        stay_pnb = p_nb + p_last
        base = torch.where(chars[:, None, :] == last[:, :, None], p_b[:, :, None], p_tot[:, :, None])
        ext_pnb = base + ext_vals[:, None, :]
        ext_pnb = torch.where(lens[:, :, None] >= max_len, torch.full_like(ext_pnb, NEG), ext_pnb)
        ext_hash = (hsh[:, :, None] * _HASH_MULT + chars[:, None, :] + 1) & _MASK32

        c_hash = torch.cat([hsh, ext_hash.reshape(b, -1)], dim=1)
        c_pb = torch.cat([stay_pb, no_mass], dim=1)
        c_pnb = torch.cat([stay_pnb, ext_pnb.reshape(b, -1)], dim=1)
        c_char = torch.cat([stay_char, chars[:, None, :].expand(b, w, k + 1).reshape(b, -1)], dim=1)

        # merge equal prefixes (equal rolling hash)
        h_s, order = torch.sort(c_hash, dim=1, stable=True)
        pb_s = torch.gather(c_pb, 1, order)
        pnb_s = torch.gather(c_pnb, 1, order)
        seg_start = torch.ones_like(h_s, dtype=torch.bool)
        seg_start[:, 1:] = h_s[:, 1:] != h_s[:, :-1]
        same = h_s[:, :, None] == h_s[:, None, :]
        # only the first candidate of each segment carries the merged mass
        pb_m = torch.where(seg_start, _segment_logaddexp(pb_s, same), torch.full_like(pb_s, NEG))
        pnb_m = torch.where(seg_start, _segment_logaddexp(pnb_s, same), torch.full_like(pnb_s, NEG))
        tot_m = _logaddexp(pb_m, pnb_m)

        # keep the top beams
        top_tot, pick = _top(tot_m, w)
        src = torch.gather(order, 1, pick)
        parent = c_parent[src]
        newchar = torch.gather(c_char, 1, src)
        n_hash = torch.gather(c_hash, 1, src)
        p_b = torch.gather(pb_m, 1, pick)
        p_nb = torch.gather(pnb_m, 1, pick)

        p_ids = torch.gather(ids, 1, parent[:, :, None].expand(b, w, max_len))
        p_lens = torch.gather(lens, 1, parent)
        grows = newchar >= 0
        at_end = (pos[None, None, :] == p_lens[:, :, None]) & grows[:, :, None]
        ids = torch.where(at_end, newchar.clamp(min=0)[:, :, None], p_ids)
        lens = p_lens + grows.to(torch.int64)
        last = torch.where(grows, newchar, torch.gather(last, 1, parent))
        # dead beams (NEG total) must not shadow live prefixes
        hsh = torch.where(top_tot <= NEG / 2, dead_hash, n_hash)

    tot = _logaddexp(p_b, p_nb)
    best = torch.argmax(tot, dim=1)
    rows = torch.arange(b, device=dev)
    return ids[rows, best].to(torch.int32), lens[rows, best].to(torch.int32), tot[rows, best]
