"""Seconds the stream's threads spend in ``download`` spans in the traced
window (reads that block until the card has done the work queued before
them: the maps, the re-read check, the ids), per photo completed."""

from portbench.core import spans


def read(run):
    own = spans.window_spans(run)
    if not own or not run.trace_summary.completed:
        return None
    return sum(s.end_ns - s.start_ns for s in own if s.name == "download") * 1e-9 / run.trace_summary.completed
