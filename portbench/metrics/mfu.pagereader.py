"""The PageReader's share of the card's bfloat16 peak (percent): the FLOPs
each page needs, the encoder once and a causal decode with a cache up to
its EOS (not the program's passes over the whole buffer), over the
window's time."""

from portbench.core import registry
from portbench.core.readings import bf16_peak_pct


def read(run):
    answers = run.state.get("answers")
    if not answers:
        return None
    cfg = run.cell.config
    ref = registry.reference(run.cell)
    total = sum(ref.page_flops(cfg, ref.served_length(row, cfg["eos_id"]) - 1) for _, row in answers)
    return bf16_peak_pct(total, run.window_s)
