"""A traced window that also keeps what ``core/spans.py`` attributes: each
device operation's launch, the idle gaps with their edges, and the spans
the program recorded in the window.

``SpanTrace`` is ``DeviceTrace`` (``core/trace.py``), whose readings it
leaves as they are, plus one more pass over the same kineto events:

- every idle gap of at least ``MIN_GAP_NS`` with its start and end, those
  between the window's edges and its first and last operation included;
- each device operation's ``Launch``: the host time and thread of the
  runtime call that issued it, joined by kineto's correlation id, its
  device time and whether it is a kernel;
- the spans the program recorded in the window (``take_spans()`` of
  ``bbocr_tpu_torch/utils/profiling.py``; none where the program has no
  such function).

``portbench/span_report.py`` traces its window with it. ``READINGS`` are the
device-attributed readings of the spans, by the names a result line would
give them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

from portbench.core import spans
from portbench.core.trace import _NOT_KERNELS, DeviceTrace, TraceSummary, _short

MIN_GAP_NS = 20_000


class Launch(NamedTuple):
    """One device operation: the host time (ns, the profiler's clock) and
    thread (CUPTI's id: the low 32 bits of the launching thread's
    ``pthread_self``, as ``threading.get_ident()`` gives it) of the runtime
    call that issued it, None where no call was joined (thread 0 where
    CUPTI gave none and no earlier call had one); its device ns not already
    covered by an operation that started before it (so that they sum to
    ``busy_s``); whether it is a kernel; its name as ``by_name`` has it."""

    host_ns: Optional[int]
    thread: Optional[int]
    device_ns: int
    kernel: bool
    name: str


@dataclass
class SpanSummary(TraceSummary):
    start_ns: int = 0  # the profiler's window, on its clock
    end_ns: int = 0
    idle: List[Tuple[int, int]] = field(default_factory=list)  # gaps of MIN_GAP_NS or more: (start_ns, end_ns)
    idle_short_s: float = 0.0  # idle in the shorter gaps
    launches: List[Launch] = field(default_factory=list)  # in device order
    spans: List[Any] = field(default_factory=list)  # the program's spans of the window


def _take_spans() -> List[Any]:
    try:
        from bbocr_tpu_torch.utils.profiling import take_spans
    except ImportError:  # a program that records no spans
        return []
    return take_spans()


def reduce_launches(events, window: Optional[Tuple[int, int]] = None) -> Tuple[List, float, List[Launch]]:
    """(idle gaps of ``MIN_GAP_NS`` or more, seconds in the shorter gaps,
    launches in device order) of kineto's events. ``window``: the
    profiler window's (start, end) ns, for the idle before its first
    operation and after its last."""
    from torch.autograd import DeviceType

    names: Dict[str, str] = {}
    calls: Dict[int, Tuple[int, int]] = {}  # correlation id -> (host ns, thread) of a runtime call
    ops = []  # (start, end, correlation id, kernel, short name)
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            # runtime and driver calls only: kineto's own events ("Activity
            # Buffer Request") carry the correlation id of a call they cut in on
            corr, thread = e.correlation_id(), e.device_resource_id() & 0xFFFFFFFF
            if corr and e.name().startswith("cu") and (thread or corr not in calls):
                calls[corr] = (e.start_ns(), thread)  # a call that names its thread wins
            continue
        dur = e.duration_ns()
        if dur <= 0:
            continue
        name = e.name()
        short = _short(name)
        short = names.setdefault(short, short)  # one string a name
        ops.append((e.start_ns(), e.start_ns() + dur, e.correlation_id(), not name.startswith(_NOT_KERNELS), short))
    # CUPTI can leave a call's thread at 0 (2 to 3 % of the launches of a
    # traced PageReader window named none, H100, torch 2.11): such a call
    # takes the thread of the call made just before it (correlation ids
    # number the calls as they are made; a thread launches in runs)
    last = 0
    for corr in sorted(calls):
        host_ns, thread = calls[corr]
        if thread:
            last = thread
        elif last:
            calls[corr] = (host_ns, last)
    ops.sort()
    idle: List[Tuple[int, int]] = []
    launches: List[Launch] = []
    idle_short = 0
    cur_end = None
    if window is not None:
        cur_end = min(window[0], ops[0][0]) if ops else window[0]
    for start, end, corr, kernel, short in ops:
        if cur_end is None or start >= cur_end:
            if cur_end is not None and start > cur_end:
                if start - cur_end >= MIN_GAP_NS:
                    idle.append((cur_end, start))
                else:
                    idle_short += start - cur_end
            own = end - start
            cur_end = end
        else:
            own = max(0, end - cur_end)
            cur_end = max(cur_end, end)
        host_ns, thread = calls.get(corr, (None, None))
        launches.append(Launch(host_ns, thread, own, kernel, short))
    if window is not None and window[1] > cur_end:
        if window[1] - cur_end >= MIN_GAP_NS:
            idle.append((cur_end, window[1]))
        else:
            idle_short += window[1] - cur_end
    return idle, idle_short * 1e-9, launches


class SpanTrace(DeviceTrace):
    """``DeviceTrace`` whose ``summary`` is a ``SpanSummary``."""

    def __enter__(self):
        _take_spans()  # the window's spans only
        super().__enter__()
        self._start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._end_ns = time.time_ns()
        return super().__exit__(*exc)

    def _reduce(self, events) -> SpanSummary:
        base = DeviceTrace._reduce(events)
        window = (self._start_ns, self._end_ns)
        idle, idle_short_s, launches = reduce_launches(events, window)
        return SpanSummary(**vars(base), start_ns=window[0], end_ns=window[1], idle=idle,
                           idle_short_s=idle_short_s, launches=launches, spans=_take_spans())


def _per_photo(tr, name: str, kernels: bool = False) -> Optional[float]:
    if not tr.completed or not any(s.name == name for s in tr.spans):
        return None
    ns, n = spans.launched_in(tr, name)
    return n / tr.completed if kernels else ns * 1e-9 / tr.completed


def _idle_outside(tr, busy) -> Optional[float]:
    return spans.idle_outside(tr, busy) if busy else None


def _step_device_ms(tr) -> Optional[float]:
    steps = sum(1 for s in tr.spans if s.name == "vlm.step")
    return spans.launched_in(tr, "vlm.step")[0] * 1e-6 / steps if steps else None


# The readings of a SpanSummary that need the launches or the gaps, each
# None where the window holds none of the spans it reads:
READINGS: Dict[str, Callable[[SpanSummary], Optional[float]]] = {
    # device seconds launched inside the engine's ``detect`` stage spans (the
    # detector's input cast, CRAFT, the thresholds, the maps' download) per photo
    "detect_device_s_per_photo.stream": lambda tr: _per_photo(tr, "detect"),
    # the same inside ``recognize`` (CRNN, LSTM steps, the re-read, CTC)
    "recognize_device_s_per_photo.stream": lambda tr: _per_photo(tr, "recognize"),
    "recognize_kernels_per_photo.stream": lambda tr: _per_photo(tr, "recognize", kernels=True),
    # share (percent) of the idle gaps' time in which no stream thread was in
    # host work (a stage span less its downloads and queue waits)
    "idle_outside_spans_pct.stream": lambda tr: _idle_outside(tr, spans.host_work(tr.spans)),
    # mean device ms launched inside one ``vlm.step`` span
    "decode_step_device_ms.pagereader": _step_device_ms,
    # share (percent) of the idle gaps' time outside every ``vlm.generate`` span
    "idle_between_calls_pct.pagereader": lambda tr: _idle_outside(
        tr, [(s.start_ns, s.end_ns) for s in tr.spans if s.name == "vlm.generate"]),
}


def reading(name: str, tr: Optional[SpanSummary]) -> Optional[float]:
    """``READINGS[name]`` of a traced window, None where it holds no span."""
    if not spans.has_spans(tr):
        return None
    return READINGS[name](tr)
