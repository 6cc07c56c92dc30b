"""The device trace of a measured window, reduced in memory.

``DeviceTrace`` opens a ``torch.profiler`` window over CUDA activity only
(no host operator events: a PageReader call issues some 128,000 kernels),
and reduces its kineto events without building the profiler's event tree
and without writing a Chrome trace: the union of the device intervals
(busy time), kernels counted and summed by name, and the longest idle
gaps, each named by the kernel that ends it (what the host was issuing).
The harness sets ``window_s`` and ``completed``, the traced window's length
and the units it completed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

_NOT_KERNELS = ("Memcpy", "Memset")


@dataclass
class TraceSummary:
    busy_s: float = 0.0
    kernels: int = 0
    by_name: Dict[str, List[float]] = field(default_factory=dict)  # name -> [count, seconds]
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # longest first
    window_s: float = 0.0
    completed: int = 0

    def top_ops(self, n: int = 10) -> List[List]:
        ranked = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name, secs] for name, (_, secs) in ranked]


def reduce_intervals(intervals: List[Tuple[int, int, str]], n_gaps: int = 10) -> Tuple[int, List[Tuple[str, int]]]:
    """(busy ns, longest gaps) of device intervals ``(start_ns, end_ns, name)``:
    busy is the length of their union; a gap lies between two pieces of the
    union and is named by the interval that ends it."""
    busy = 0
    gaps: List[Tuple[str, int]] = []
    cur_start = cur_end = None
    for start, end, name in sorted(intervals):
        if cur_end is None:
            cur_start, cur_end = start, end
        elif start > cur_end:
            busy += cur_end - cur_start
            gaps.append(("before " + name, start - cur_end))
            cur_start, cur_end = start, end
        elif end > cur_end:
            cur_end = end
    if cur_end is not None:
        busy += cur_end - cur_start
    gaps.sort(key=lambda g: -g[1])
    return busy, gaps[:n_gaps]


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[: limit - 3] + "..."


class DeviceTrace:
    """Context manager: ``with DeviceTrace() as t: ...``; then ``t.summary``."""

    def __init__(self):
        self.summary = None
        self._prof = None

    def __enter__(self):
        import torch

        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = self._reduce(self._prof.profiler.kineto_results.events())
        self._prof = None
        return False

    @staticmethod
    def _reduce(events) -> TraceSummary:
        from torch.autograd import DeviceType

        out = TraceSummary()
        intervals = []
        for e in events:
            if e.device_type() != DeviceType.CUDA:
                continue
            dur = e.duration_ns()
            if dur <= 0:
                continue
            name = e.name()
            start = e.start_ns()
            intervals.append((start, start + dur, name))
            slot = out.by_name.setdefault(_short(name), [0, 0.0])
            slot[0] += 1
            slot[1] += dur * 1e-9
            if not name.startswith(_NOT_KERNELS):
                out.kernels += 1
        busy, gaps = reduce_intervals(intervals)
        out.busy_s = busy * 1e-9
        out.gaps = [(_short(name), ns * 1e-9) for name, ns in gaps]
        return out
