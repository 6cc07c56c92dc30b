"""Per-stage wall-clock accumulator the engine reports through
``timings()``, and ``device_trace``, a profiler trace around a block."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional


class StageTimer:
    """Thread-safe named-stage wall-clock accumulator."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, Dict[str, float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
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


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block when a directory is
    configured (``log_dir``, else ``BB_OCR_PROFILE_DIR``), exported as a
    Chrome trace (``trace_<pid>_<ns>.json``) into it on exit; a no-op
    otherwise. It records the CPU, and CUDA where a card is present."""
    log_dir = log_dir or os.environ.get("BB_OCR_PROFILE_DIR")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
