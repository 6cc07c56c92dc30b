"""CTC loss with ``optax.ctc_loss``'s semantics, as a recursion over frames.

The forward-variable recursion of ``optax.ctc_loss_with_forward_probs``
written out in PyTorch ops, in log space, one step per frame: the blank
(``phi``) and label (``emit``) states, ``log_epsilon = -1e5`` for log 0, a
padded frame carrying the previous state forward by ``pad * prev + (1 -
pad) * next``, and the final epsilon transition. The gradient comes from
autograd.

``F.ctc_loss`` differs: where no alignment exists (a label longer than its
frames allow) it returns ``inf`` (or 0 with ``zero_infinity``) where optax
returns a finite, large loss; it takes lengths, not paddings.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _update_phi(phi: torch.Tensor, added: torch.Tensor) -> torch.Tensor:
    """``phi[:, 1:]`` log-added with ``added``; ``phi[:, 0]`` kept."""
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=-1)


def ctc_loss(
    logits: torch.Tensor,
    logit_paddings: torch.Tensor,
    labels: torch.Tensor,
    label_paddings: torch.Tensor,
    blank_id: int = 0,
    log_epsilon: float = -1e5,
) -> torch.Tensor:
    """(B,) negative log-likelihoods. ``logits`` (B, T, K); paddings 1.0 on
    padded frames and labels (labels right-padded); ``labels`` (B, N) ids."""
    b, t, _ = logits.shape
    n = labels.shape[1]
    labels = labels.long()
    logprobs = F.log_softmax(logits.float(), dim=-1)
    label_lens = n - label_paddings.sum(dim=1).long()
    # repeat[b, i] is 1 when label i equals label i + 1
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    eps = torch.full((), log_epsilon, dtype=torch.float32, device=logits.device)
    logprobs_phi = logprobs[:, :, blank_id : blank_id + 1].transpose(0, 1)  # (T, B, 1)
    logprobs_emit = torch.gather(logprobs, 2, labels[:, None, :].expand(b, t, n)).transpose(0, 1)  # (T, B, N)
    pads = logit_paddings.float().transpose(0, 1)[..., None]  # (T, B, 1)

    phi = torch.full((b, n + 1), log_epsilon, dtype=torch.float32, device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=-1)
    emit = torch.full((b, n), log_epsilon, dtype=torch.float32, device=logits.device)
    eps_repeat = eps * repeat
    eps_not_repeat = eps * (1.0 - repeat)
    for step in range(t):
        prev_phi_orig = phi
        # emit-to-phi epsilon transition, except if the next label repeats
        prev_phi = _update_phi(phi, emit + eps_repeat)
        lp_emit, lp_phi, pad = logprobs_emit[step], logprobs_phi[step], pads[step]
        # phi-to-emit transition, and the label's self-loop
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        # blank self-loop; emit-to-phi blank transition only where the next label repeats
        next_phi = _update_phi(prev_phi + lp_phi, emit + lp_phi + eps_not_repeat)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    # the last row takes the last epsilon transition
    phi_last = _update_phi(phi, emit)
    return -torch.gather(phi_last, 1, label_lens[:, None])[:, 0]
