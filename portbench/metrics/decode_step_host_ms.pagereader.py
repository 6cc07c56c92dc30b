"""Mean host milliseconds of one ``vlm.step`` span in the traced window:
the time the host takes to issue one decoder pass (no read waits on the
card inside the loop)."""

from portbench.core import spans


def read(run):
    steps = [s.end_ns - s.start_ns for s in spans.window_spans(run) if s.name == "vlm.step"]
    return sum(steps) * 1e-6 / len(steps) if steps else None
