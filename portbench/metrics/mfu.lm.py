"""The language model's share of the card's bfloat16 peak (percent): the
reference's FLOPs of the requests completed in the window (a forward over
each prompt and the tokens fed back, naive latent attention, the head at
each served position), over the window's time."""

from portbench.core import registry
from portbench.core.readings import bf16_peak_pct


def read(run):
    answers = run.state.get("answers")
    if not answers:
        return None
    cfg = run.cell.config
    ref = registry.reference(run.cell)
    eos = cfg["assumed"]["eos_token_id"]
    total = sum(ref.request_flops(cfg, len(prompt), ref.served_length(row, eos)) for prompt, row in answers)
    return bf16_peak_pct(total, run.window_s)
