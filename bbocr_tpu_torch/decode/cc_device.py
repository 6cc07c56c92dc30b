"""Connected-component labeling on the device.

Counterpart of ``bbocr_tpu/decode/cc_device.py``, the labeling step of the
single-dispatch fast path (``runtime/fastpath.py``). A component's label is
``1 + the smallest flat index`` of its pixels (4-connectivity).

Algorithm: iterative min-label propagation (each step takes the min over
the 4-neighbourhood) with pointer jumping every ``jump_every`` steps
(``label[i] <- label[label[i]]``, labels being flat indices). The JAX
package runs it as a ``lax.while_loop`` that stops at the first step that
changes nothing, or after ``max_iters`` steps. Its fixed point is unique,
and steps after it change nothing, so here the host looks at the labels
only once per ``jump_every`` steps (one synchronisation per round) and
stops at the first round that changed nothing, or after exactly
``max_iters`` steps.
"""

from __future__ import annotations

import torch

_BIG = 2**31 - 1


def _neighbor_min(lab: torch.Tensor) -> torch.Tensor:
    """Min over the 4-neighbourhood, edges padded with the BIG sentinel."""
    pad = torch.nn.functional.pad(lab[None], (1, 1, 1, 1), value=_BIG)[0]
    return torch.minimum(
        torch.minimum(pad[2:, 1:-1], pad[:-2, 1:-1]),
        torch.minimum(pad[1:-1, 2:], pad[1:-1, :-2]),
    )


def label_components_device(mask: torch.Tensor, max_iters: int = 1024, jump_every: int = 8):
    """(H, W) bool/int mask -> ((H, W) int32 labels, steps run).

    Background pixels get 0; each component gets ``1 + min flat index``
    over its pixels."""
    h, w = mask.shape
    m = mask != 0
    big = torch.full((h, w), _BIG, dtype=torch.int64, device=mask.device)
    lab = torch.where(m, torch.arange(h * w, device=mask.device).reshape(h, w), big)
    it = 0
    while it < max_iters:
        start = lab
        for _ in range(min(jump_every - it % jump_every, max_iters - it)):
            lab = torch.where(m, torch.minimum(lab, _neighbor_min(lab)), big)
            it += 1
            if it % jump_every == 0:
                # pointer jumping: labels are flat indices into the same grid
                tgt = lab.reshape(-1)[lab.clamp(0, h * w - 1).reshape(-1)].reshape(h, w)
                lab = torch.where(lab != _BIG, torch.minimum(lab, tgt), big)
        if torch.equal(lab, start):
            break
    return torch.where(m, lab + 1, torch.zeros_like(lab)).to(torch.int32), it


def component_stats_device(labels: torch.Tensor, k: int, score: torch.Tensor = None):
    """Top-``k`` components by population, on the device.

    Returns ``(ids, x0, y0, x1, y1, count)``, each of shape (k,) and zero
    past the number of real components, plus ``peak`` (the max of
    ``score`` over the component, float32) when ``score`` is given. Ties in
    population go to the smallest label, as ``jnp.argmax`` takes them."""
    h, w = labels.shape
    dev = labels.device
    flat = labels.reshape(-1).to(torch.int64)
    picked = torch.zeros(h * w + 1, dtype=torch.bool, device=dev)
    picked[0] = True  # the JAX loop starts with id 0 excluded
    ids = []
    for _ in range(k):
        cand = torch.where(picked[flat], torch.zeros_like(flat), flat)
        counts = torch.zeros(h * w + 1, dtype=torch.int64, device=dev)
        counts.index_add_(0, cand, (cand > 0).to(torch.int64))
        best = torch.argmax(counts)
        picked[best] = True
        ids.append(best)
    ids = torch.stack(ids)

    sel = labels.reshape(1, h, w) == ids.reshape(k, 1, 1)
    ys = torch.arange(h, device=dev).reshape(1, h, 1)
    xs = torch.arange(w, device=dev).reshape(1, 1, w)
    cnt = sel.sum(dim=(1, 2))
    x0 = torch.where(sel, xs, w).amin(dim=(1, 2))
    x1 = torch.where(sel, xs, -1).amax(dim=(1, 2))
    y0 = torch.where(sel, ys, h).amin(dim=(1, 2))
    y1 = torch.where(sel, ys, -1).amax(dim=(1, 2))
    valid = (ids > 0) & (cnt > 0)
    zero = torch.zeros_like(ids)
    out = tuple(torch.where(valid, v, zero).to(torch.int32) for v in (ids, x0, y0, x1, y1, cnt))
    if score is not None:
        peak = torch.where(sel, score.reshape(1, h, w).to(torch.float32), 0.0).amax(dim=(1, 2))
        out = out + (torch.where(valid, peak, torch.zeros_like(peak)),)
    return out
