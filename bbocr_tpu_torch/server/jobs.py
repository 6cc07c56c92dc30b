"""Job runtime: background extraction jobs, per-job trace/log/status
buffers, transfer store.

Mirrors the reference's runtime semantics (``pipeline_demo/i2j_ui/app/main.py``):

- one worker thread per job, globally serialized by a BoundedSemaphore(1)
  (``main.py:85,463``) — jobs queue but execute one at a time (the
  engine batches internally; cross-job serialization keeps streams
  unambiguous);
- per-job trace buffer with sequence numbers, where heavy base64 image
  fields are sent once per image and elided afterwards (``main.py:126-181``),
  steps capped to the last 50, buffers trimmed to 200/1000 entries;
- stdout/stderr tee during the job with consecutive-duplicate coalescing
  "(xN)" (``main.py:197-237``), not forwarded to the console;
- job states queued -> running -> done/error with a status stream;
- ephemeral accept->pricing transfer store with 300 s TTL (``main.py:100-124``).

Copied from ``bbocr_tpu/server/jobs.py``. ``JobManager.submit`` swaps
``sys.stdout`` and ``sys.stderr`` process-wide while a job runs, as the JAX
one does: anything any thread prints meanwhile goes into that job's log.
"""

from __future__ import annotations

import sys
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

HEAVY_FIELDS = (
    "original_b64",
    "preprocessed_b64",
    "edge_cropped_b64",
    "auto_cropped_b64",
)

TRACE_BUFFER_MAX = 200
LOG_BUFFER_MAX = 1000
STEPS_TAIL = 50
TRANSFER_TTL_SECONDS = 300.0


class LogTee:
    """File-like tee: captures writes into a per-job buffer (and NOT the
    console, matching the reference's swap) with duplicate coalescing."""

    def __init__(self, sink: Callable[[str], None]):
        self._sink = sink
        self._buf = ""
        self._last_line: Optional[str] = None
        self._dup_count = 0
        self._lock = threading.Lock()

    def write(self, data: str) -> int:
        with self._lock:
            self._buf += data
            while "\n" in self._buf:
                line, _, self._buf = self._buf.partition("\n")
                self._emit(line)
        return len(data)

    def _emit(self, line: str) -> None:
        if line == self._last_line:
            self._dup_count += 1
            return
        if self._dup_count:
            self._sink(f"{self._last_line} (x{self._dup_count + 1})")
            self._dup_count = 0
            self._last_line = None
        if line.strip() == "" and self._last_line is None:
            return
        self._sink(line)
        self._last_line = line

    def flush(self) -> None:
        with self._lock:
            if self._dup_count and self._last_line is not None:
                self._sink(f"{self._last_line} (x{self._dup_count + 1})")
                self._dup_count = 0
            if self._buf:
                self._sink(self._buf)
                self._buf = ""
            self._last_line = None

    def isatty(self) -> bool:
        return False


class _Stream:
    """Seq-numbered append buffer with trimming."""

    def __init__(self, max_len: int):
        self.items: List[Dict[str, Any]] = []
        self.seq = 0
        self.max_len = max_len

    def push(self, payload: Dict[str, Any]) -> None:
        self.seq += 1
        self.items.append({"seq": self.seq, "ts": time.time(), **payload})
        if len(self.items) > self.max_len:
            del self.items[: len(self.items) - self.max_len]

    def after(self, seq: int, limit: int = 100) -> List[Dict[str, Any]]:
        return [i for i in self.items if i["seq"] > seq][:limit]


class JobManager:
    """Thread-per-job execution with per-id streams, serialized by one
    semaphore."""

    def __init__(self, max_concurrent: int = 1):
        self._sem = threading.BoundedSemaphore(max_concurrent)
        self._lock = threading.Lock()
        self.jobs: Dict[str, Dict[str, Any]] = {}
        self._traces: Dict[str, _Stream] = {}
        self._logs: Dict[str, _Stream] = {}
        self._statuses: Dict[str, _Stream] = {}
        self._sent_heavy: Dict[str, Dict[int, set]] = {}

    # ------------------------------ streams ---------------------------

    def reset_streams(self, job_id: str) -> None:
        with self._lock:
            self._traces[job_id] = _Stream(TRACE_BUFFER_MAX)
            self._logs[job_id] = _Stream(LOG_BUFFER_MAX)
            self._statuses[job_id] = _Stream(TRACE_BUFFER_MAX)
            self._sent_heavy[job_id] = {}

    def push_trace(self, job_id: str, trace: Dict[str, Any]) -> None:
        """Dedup heavy fields per image index, cap steps, append w/ seq."""
        with self._lock:
            stream = self._traces.setdefault(job_id, _Stream(TRACE_BUFFER_MAX))
            sent_map = self._sent_heavy.setdefault(job_id, {})
            slim = dict(trace)
            images = []
            for idx, img in enumerate(trace.get("images", []) or []):
                img = dict(img)
                sent = sent_map.setdefault(idx, set())
                for field in HEAVY_FIELDS:
                    if field in img:
                        if field in sent:
                            img[field] = None  # already delivered once
                        elif img[field] is not None:
                            sent.add(field)
                images.append(img)
            slim["images"] = images
            steps = trace.get("steps") or []
            if len(steps) > STEPS_TAIL:
                slim["steps"] = steps[-STEPS_TAIL:]
            stream.push({"trace": slim})

    def push_log(self, job_id: str, line: str) -> None:
        with self._lock:
            self._logs.setdefault(job_id, _Stream(LOG_BUFFER_MAX)).push({"line": line})

    def push_status(self, job_id: str, payload: Dict[str, Any]) -> None:
        with self._lock:
            self._statuses.setdefault(job_id, _Stream(TRACE_BUFFER_MAX)).push(payload)

    def traces_after(self, job_id: str, seq: int, limit: int = 100) -> List[Dict[str, Any]]:
        with self._lock:
            s = self._traces.get(job_id)
            return s.after(seq, limit) if s else []

    def logs_after(self, job_id: str, seq: int, limit: int = 100) -> List[Dict[str, Any]]:
        with self._lock:
            s = self._logs.get(job_id)
            return s.after(seq, limit) if s else []

    def statuses_after(self, job_id: str, seq: int, limit: int = 100) -> List[Dict[str, Any]]:
        with self._lock:
            s = self._statuses.get(job_id)
            return s.after(seq, limit) if s else []

    # ------------------------------- jobs ------------------------------

    def submit(self, job_id: str, fn: Callable[[], Any], files: Optional[List[str]] = None) -> str:
        files = files or []
        with self._lock:
            self.jobs[job_id] = {"status": "queued", "files": files}
        self.push_status(job_id, {"status": "queued", "files": files})

        def runner():
            self._sem.acquire()
            old_out, old_err = sys.stdout, sys.stderr
            tee = LogTee(lambda line: self.push_log(job_id, line))
            try:
                with self._lock:
                    self.jobs[job_id]["status"] = "running"
                self.push_status(job_id, {"status": "running", "files": files})
                sys.stdout = tee
                sys.stderr = tee
                result = fn()
                tee.flush()
                with self._lock:
                    self.jobs[job_id].update(status="done", metadata=result)
                self.push_status(job_id, {"status": "done", "files": files, "metadata": result})
            except Exception as e:  # job errors surface via status, not crash
                tee.flush()
                with self._lock:
                    self.jobs[job_id].update(status="error", error=str(e))
                self.push_status(job_id, {"status": "error", "error": str(e)})
            finally:
                sys.stdout = old_out
                sys.stderr = old_err
                self._sem.release()

        threading.Thread(target=runner, daemon=True).start()
        return job_id

    def get(self, job_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            job = self.jobs.get(job_id)
            return dict(job) if job else None

    def is_active(self, job_id: str) -> bool:
        job = self.get(job_id)
        return bool(job) and job["status"] in ("queued", "running")


class TransferStore:
    """Ephemeral accept->pricing handoff keyed by one-time tokens."""

    def __init__(self, ttl_seconds: float = TRANSFER_TTL_SECONDS):
        self._ttl = ttl_seconds
        self._lock = threading.Lock()
        self._items: Dict[str, Any] = {}

    def put(self, payload: Any) -> str:
        key = uuid.uuid4().hex
        with self._lock:
            self._gc()
            self._items[key] = (time.time(), payload)
        return key

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            self._gc()
            item = self._items.get(key)
            return item[1] if item else None

    def _gc(self) -> None:
        now = time.time()
        dead = [k for k, (ts, _) in self._items.items() if now - ts > self._ttl]
        for k in dead:
            del self._items[k]
