"""Share of the traced window's ``lm.step`` spans whose step replayed a
captured CUDA graph (the span's ``graph`` attribute). None where no step
carries the attribute."""

from portbench.core import spans


def read(run):
    steps = [s.attrs["graph"] for s in spans.window_spans(run) if s.name == "lm.step" and "graph" in s.attrs]
    return sum(map(bool, steps)) / len(steps) if steps else None
