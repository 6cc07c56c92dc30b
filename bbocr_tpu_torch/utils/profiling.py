"""Spans and stage times of the engine and the PageReader, and
``device_trace``, a profiler trace around a block.

A span is one piece of work on one host thread: its name, an id, the id of
the span open around it on the same thread (its parent; 0 at a root), the
batch it serves, the thread, its start and end in ns of ``time.time_ns()``
(the clock on which kineto stamps a profiler session's events, the card's
included), and a few counts or flags. Spans are recorded while a
``torch.profiler`` session is active or inside ``record_spans()``, kept in
memory in the process and handed over by ``take_spans()``; otherwise a
boundary costs one flag check. ``StageTimer.stage`` is the engine's stage
span: it always adds to the per-stage totals that ``timings()`` reports,
and records the span when recording is on.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


@dataclass
class Span:
    id: int
    parent: int  # the span open around it on its thread; 0 at a root
    batch: int  # the batch's sequence number (``batch()``); 0 outside one
    name: str
    tid: int  # threading.get_native_id(): the thread's row in a Chrome trace
    ident: int  # threading.get_ident(): CUPTI names a launch's thread by its low 32 bits
    start_ns: int
    end_ns: int = 0
    attrs: Dict[str, Any] = field(default_factory=dict)


class _Thread(threading.local):
    def __init__(self):
        self.tid = threading.get_native_id()
        self.ident = threading.get_ident()
        self.stack: List[Span] = []
        self.batch = 0


_thread = _Thread()
_lock = threading.Lock()
_kept: List[Span] = []
_ids = itertools.count(1)
_batches = itertools.count(1)
_forced = 0  # open record_spans() blocks


def recording() -> bool:
    """True inside ``record_spans()`` or while a profiler session is active:
    torch's process-wide flag, as ``torch.autograd._profiler_enabled()``
    holds only on the thread that started the session, and a pipeline's
    threads may start inside it."""
    return _forced > 0 or _autograd_profiler._is_profiler_enabled


@contextlib.contextmanager
def record_spans():
    """Record spans inside the block, with or without a profiler session."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def take_spans() -> List[Span]:
    """The spans closed since the last call, in the order they closed; the
    store is emptied (one reader at a time)."""
    global _kept
    with _lock:
        out, _kept = _kept, []
    return out


@contextlib.contextmanager
def batch(number: int = 0):
    """The block serves one batch: spans opened in it on this thread carry
    ``number``, or a new sequence number when it is 0 (the other threads of
    a pipeline enter with the number they were handed). Yields the number."""
    th = _thread
    prev = th.batch
    th.batch = number or next(_batches)
    try:
        yield th.batch
    finally:
        th.batch = prev


def _open(name: str, attrs: Dict[str, Any]) -> Optional[Span]:
    if not recording():
        return None
    th = _thread
    parent = th.stack[-1].id if th.stack else 0
    sp = Span(next(_ids), parent, th.batch, name, th.tid, th.ident, time.time_ns(), attrs=attrs)
    th.stack.append(sp)
    return sp


def _close(sp: Span, end_ns: int) -> None:
    sp.end_ns = end_ns
    stack = _thread.stack
    if stack and stack[-1] is sp:
        stack.pop()
    else:
        stack.remove(sp)
    with _lock:
        _kept.append(sp)


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[Optional[Span]]:
    """A span around the block when recording is on (yields it, so that the
    block may add attributes), else nothing (yields None)."""
    sp = _open(name, attrs)
    try:
        yield sp
    finally:
        if sp is not None:
            _close(sp, time.time_ns())


class StageTimer:
    """Thread-safe named-stage wall-clock accumulator whose stages are spans."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, Dict[str, float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        sp = _open(name, {})
        t0 = sp.start_ns if sp is not None else time.time_ns()
        try:
            yield sp
        finally:
            t1 = time.time_ns()
            if sp is not None:
                _close(sp, t1)
            dt = (t1 - t0) * 1e-9
            with self._lock:
                s = self._stats.setdefault(
                    name, {"count": 0, "total_s": 0.0, "max_s": 0.0}
                )
                s["count"] += 1
                s["total_s"] += dt
                s["max_s"] = max(s["max_s"], dt)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out = {}
            for name, s in self._stats.items():
                out[name] = {
                    "count": int(s["count"]),
                    "total_s": round(s["total_s"], 4),
                    "mean_s": round(s["total_s"] / max(s["count"], 1), 4),
                    "max_s": round(s["max_s"], 4),
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


def _chrome_events(spans: List[Span], base_ns: int = 0) -> List[Dict[str, Any]]:
    """Spans as Chrome trace events on their threads' rows (``ts`` in us
    from ``base_ns``, as ``torch.profiler`` writes its own events)."""
    pid = os.getpid()
    return [
        {
            "ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": s.tid,
            "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"id": s.id, "parent": s.parent, "batch": s.batch, **s.attrs},
        }
        for s in spans
    ]


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block when a directory is
    configured (``log_dir``, else ``BB_OCR_PROFILE_DIR``), exported as a
    Chrome trace (``trace_<pid>_<ns>.json``) into it on exit, with the
    block's spans beside the profiler's events; a no-op otherwise. It
    records the CPU, and CUDA where a card is present."""
    log_dir = log_dir or os.environ.get("BB_OCR_PROFILE_DIR")
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    take_spans()  # only the block's spans go into its trace
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(_chrome_events(take_spans(), int(trace.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(trace, f)
