"""Share of the traced window (percent) that the stream's middle thread
(the one with ``boxes`` spans: the maps' download, box extraction, crop
warps, the recognizer's dispatch) spends in host work: its stage spans
less the ``download`` spans in them, where it waits for the card."""

from portbench.core import spans


def read(run):
    own = spans.window_spans(run)
    mid = {s.tid for s in own if s.name == "boxes"}
    if not mid or run.trace_summary.window_s <= 0:
        return None
    work = spans.host_work(own, mid)
    return 100.0 * sum(b - a for a, b in work) * 1e-9 / run.trace_summary.window_s
