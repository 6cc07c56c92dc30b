"""Mean milliseconds of one ``lm.step`` span in the traced window, on the
host's clock. A step is one graph replay, and the host blocks in it while
the card's launch queue is full: in steady state the span lasts as long as
the card takes for a step, so this is the decode step's time, not the
host's cost of issuing it."""

from portbench.core import spans


def read(run):
    steps = [s.end_ns - s.start_ns for s in spans.window_spans(run) if s.name == "lm.step"]
    return sum(steps) * 1e-6 / len(steps) if steps else None
