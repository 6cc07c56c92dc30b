"""Share of the traced window's ``vlm.step`` spans whose step replayed a
captured CUDA graph (the span's ``graph`` attribute). None where no step
carries the attribute: no traced window, or a program whose steps do not
say how they ran."""

from portbench.core import spans


def read(run):
    steps = [s.attrs["graph"] for s in spans.window_spans(run) if s.name == "vlm.step" and "graph" in s.attrs]
    return sum(map(bool, steps)) / len(steps) if steps else None
