"""Share of the recognizer's dispatches in the traced window that ran the
contrast re-read: ``crnn`` spans flagged ``reread`` over those that are
not (one of each a width bucket whose worst valid read fell below
``contrast_ths``)."""

from portbench.core import spans


def read(run):
    crnn = [s for s in spans.window_spans(run) if s.name == "crnn"]
    first = sum(1 for s in crnn if not s.attrs.get("reread"))
    if not first:
        return None
    return (len(crnn) - first) / first
