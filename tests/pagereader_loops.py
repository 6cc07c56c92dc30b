"""The PageReader's greedy decode as the full-buffer loop that the JAX
``lax.scan`` runs, written out for the tests to hold
``models/vlm.py::greedy_generate`` to: at each of the ``max_len - 1``
steps the whole token buffer goes through ``PageReader.decode``, the argmax
of row ``t`` (the first index wins ties) fills slot ``t + 1``, and a row
that holds EOS keeps emitting EOS. Imports nothing of JAX."""

import torch

from bbocr_tpu_torch.models import vlm


@torch.no_grad()
def full_buffer_generate(model, page, max_len=vlm.MAX_JSON_LEN):
    """(tokens (B, max_len), logits (max_len - 1, B, vocab)): the ids and
    each step's float32 logits of row ``t``."""
    ctx = model.encode(page)
    b = page.shape[0]
    tokens = torch.full((b, max_len), vlm.PAD_ID, dtype=torch.int64, device=page.device)
    tokens[:, 0] = vlm.BOS_ID
    steps = []
    for t in range(max_len - 1):
        logits = model.decode(ctx, tokens)[:, t, :]
        done = torch.any(tokens == vlm.EOS_ID, dim=1)
        tokens[:, t + 1] = torch.where(done, torch.full_like(tokens[:, 0], vlm.EOS_ID), torch.argmax(logits, dim=-1))
        steps.append(logits)
    return tokens, torch.stack(steps)


@torch.no_grad()
def cached_steps(model, page, max_len=vlm.MAX_JSON_LEN):
    """(tokens, logits) as ``full_buffer_generate`` returns them, from
    ``vlm.DecodeState.step`` run eagerly on the page's device."""
    ctx = model.encode(page)
    state = vlm.DecodeState(model, ctx.shape[0], ctx.shape[1], max_len, ctx.device)
    state.load(model, ctx)
    steps = []
    for _ in range(max_len - 1):
        state.step()
        steps.append(state.logits.clone())
    return state.tokens.clone(), torch.stack(steps)
