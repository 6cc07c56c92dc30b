"""The OCR stream's share of the card's bfloat16 peak (percent): the FLOPs
the window's photos need, the detector at each photo's canvas and the
recognizer at each returned box's bucket width (twice where the contrast
re-read ran), counted on the plain reference with ``FlopCounterMode``,
over the window's time. Boxes whose text came back empty are not
returned, so not counted: the share is a lower bound."""

from portbench.core import registry
from portbench.core.readings import bf16_peak_pct


def read(run):
    answers = run.state.get("answers")
    if not answers:
        return None
    cfg = run.cell.config
    ref = registry.reference(run.cell)
    eng = cfg["engine"]
    craft = {tuple(c): ref.craft_flops(registry.ROOT, cfg, tuple(c)) for c in eng["canvases"]}
    crnn = {w: ref.crnn_flops(registry.ROOT, cfg, w) for w in eng["width_buckets"]}
    grays = run.state["grays"]
    total = sum(ref.photo_flops(ans, grays[photo].shape, cfg, craft, crnn) for photo, ans in answers)
    return bf16_peak_pct(total, run.window_s)
