"""The program's spans against the device trace of a traced window.

A span (``bbocr_tpu_torch/utils/profiling.py``) has a name, an id, its
parent, batch and thread, a start and an end on the profiler's clock and a
few attributes. ``window_spans`` hands a run's readers the spans the
program recorded in its traced window. ``core/launches.py`` keeps each
device operation's launch and the idle gaps besides; here a launch is put
down to the innermost span open on its thread at its host time, and the
gaps are intersected with spans. Every function takes the span objects as
the program makes them (reading only their fields), and readers return None
where a window holds no span.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# the engine's stage spans (``StageTimer.stage``)
STAGES = frozenset(("letterbox", "detect", "boxes", "rectify", "recognize", "fast"))
# spans in which a thread waits: for the card (a read that blocks on it) or on a queue
WAITS = frozenset(("download", "stream.wait"))

Interval = Tuple[int, int]


def thread_key(ident: int) -> int:
    """A span's thread as CUPTI names a launch's: the low 32 bits."""
    return ident & 0xFFFFFFFF


def innermost(spans: Sequence, launches: Sequence) -> List[Optional[object]]:
    """For each launch, the innermost span open on its thread at its host
    time, or None (no span open, or no runtime call joined). A thread's
    spans nest, so the latest-started span still open is the innermost."""
    by_thread: Dict[int, List] = defaultdict(list)
    for s in spans:
        by_thread[thread_key(s.ident)].append(s)
    out: List[Optional[object]] = [None] * len(launches)
    order = sorted((ln.thread, ln.host_ns, i) for i, ln in enumerate(launches) if ln.host_ns is not None)
    k = 0
    while k < len(order):
        thread = order[k][0]
        own = sorted(by_thread.get(thread, ()), key=lambda s: (s.start_ns, -s.end_ns))
        stack: List = []
        j = 0
        while k < len(order) and order[k][0] == thread:
            _, t, i = order[k]
            while j < len(own) and own[j].start_ns <= t:
                while stack and stack[-1].end_ns < own[j].start_ns:
                    stack.pop()
                stack.append(own[j])
                j += 1
            while stack and stack[-1].end_ns < t:
                stack.pop()
            out[i] = stack[-1] if stack else None
            k += 1
    return out


def lineage(spans: Iterable) -> Dict[int, Tuple[str, ...]]:
    """Span id -> the names from the span up to its root."""
    by_id = {s.id: s for s in spans}
    out: Dict[int, Tuple[str, ...]] = {}

    def names(s) -> Tuple[str, ...]:
        if s.id not in out:
            parent = by_id.get(s.parent)
            out[s.id] = (s.name,) + (names(parent) if parent is not None else ())
        return out[s.id]

    for s in by_id.values():
        names(s)
    return out


def launched_in(tr, name: str) -> Tuple[int, int]:
    """(device ns, kernels) of the launches made inside spans called
    ``name`` (in them or in a span nested in them)."""
    line = lineage(tr.spans)
    ns = kernels = 0
    for ln, s in zip(tr.launches, innermost(tr.spans, tr.launches)):
        if s is not None and name in line[s.id]:
            ns += ln.device_ns
            kernels += ln.kernel
    return ns, kernels


def coverage(tr) -> Dict[str, float]:
    """Device seconds and launches inside some span, outside every span
    (the driver's own copies), and with no runtime call joined."""
    out = dict.fromkeys(("inside_s", "outside_s", "unjoined_s"), 0.0)
    out.update(dict.fromkeys(("launches_inside", "launches_outside", "launches_unjoined"), 0))
    for ln, s in zip(tr.launches, innermost(tr.spans, tr.launches)):
        where = "inside" if s is not None else "outside" if ln.host_ns is not None else "unjoined"
        out[where + "_s"] += ln.device_ns * 1e-9
        out["launches_" + where] += 1
    out["busy_s"] = tr.busy_s
    return out


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap_ns(xs: Sequence[Interval], ys: Sequence[Interval]) -> int:
    """Length of the intersection of two unions of disjoint sorted intervals."""
    total = i = j = 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _ancestors(by_id: Dict, s):
    p = by_id.get(s.parent)
    while p is not None:
        yield p
        p = by_id.get(p.parent)


def host_work(spans: Sequence, threads: Optional[set] = None) -> List[Interval]:
    """The intervals in which a thread does host work in a stage: its
    outermost stage spans less the ``download`` and ``stream.wait`` spans
    inside them (``threads``: native thread ids to keep, else all)."""
    own = [s for s in spans if threads is None or s.tid in threads]
    by_id = {s.id: s for s in own}
    outer = {s.id: s for s in own if s.name in STAGES and not any(a.name in STAGES for a in _ancestors(by_id, s))}
    holes: Dict[int, List[Interval]] = defaultdict(list)
    for s in own:
        if s.name in WAITS:
            for a in _ancestors(by_id, s):
                if a.id in outer:
                    holes[a.id].append((s.start_ns, s.end_ns))
    out: List[Interval] = []
    for s in outer.values():
        start = s.start_ns
        for a, b in union(holes[s.id]):
            if a > start:
                out.append((start, a))
            start = max(start, b)
        if s.end_ns > start:
            out.append((start, s.end_ns))
    return out


def idle_outside(tr, busy: Sequence[Interval]) -> Optional[float]:
    """Share (percent) of the idle gaps' time outside the union ``busy``."""
    total = sum(b - a for a, b in tr.idle)
    if not total:
        return None
    return 100.0 * (total - overlap_ns(tr.idle, union(busy))) / total


def idle_by_span(tr) -> Dict[Tuple[int, str], int]:
    """Idle ns of the gaps by thread and the innermost span open on it
    (``"-"`` where none was): (native thread id, span name) -> ns. Each
    thread's entries sum to the gaps' total."""
    by_thread: Dict[int, List] = defaultdict(list)
    for s in tr.spans:
        by_thread[s.tid].append(s)
    total = sum(b - a for a, b in tr.idle)
    out: Dict[Tuple[int, str], int] = defaultdict(int)
    for tid, own in by_thread.items():
        # sweep the thread's span boundaries (ends first at a tie); between
        # two, the top of the stack of open spans is the innermost
        marks = sorted([(s.start_ns, 1, i) for i, s in enumerate(own)] + [(s.end_ns, 0, i) for i, s in enumerate(own)])
        stack: List[int] = []
        pieces: List[Tuple[int, int, str]] = []
        for (t, is_start, i), (t_next, _, _) in zip(marks, marks[1:]):
            if is_start:
                stack.append(i)
            else:
                stack.remove(i)
            if stack and t_next > t:
                pieces.append((t, t_next, own[stack[-1]].name))
        covered = g = 0
        for a, b, name in pieces:  # both in time order
            while g < len(tr.idle) and tr.idle[g][1] <= a:
                g += 1
            k = g
            while k < len(tr.idle) and tr.idle[k][0] < b:
                ns = min(b, tr.idle[k][1]) - max(a, tr.idle[k][0])
                out[(tid, name)] += ns
                covered += ns
                k += 1
        out[(tid, "-")] += total - covered
    return dict(out)


def window_spans(run) -> List:
    """The spans the program recorded in the run's traced window: taken from
    the program once (recording is on only while the profiler is) and kept
    in ``run.state["spans"]`` for the other readers; none without a traced
    window or where the program has no ``take_spans``."""
    if run.trace_summary is None:
        return []
    if "spans" not in run.state:
        try:
            from bbocr_tpu_torch.utils.profiling import take_spans
        except ImportError:  # a program that records no spans
            run.state["spans"] = []
        else:
            run.state["spans"] = take_spans()
    return run.state["spans"]


def has_spans(tr) -> bool:
    """A traced window in which the program recorded spans."""
    return tr is not None and bool(getattr(tr, "spans", None))
